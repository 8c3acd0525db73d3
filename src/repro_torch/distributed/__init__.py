"""Distributed helpers of the port: the kill -9 fault injection
(``fault.crash_point``) the durability battery drives, the straggler
monitor and the crash-restart training driver."""
