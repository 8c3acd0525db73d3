"""Distributed helpers of the port: so far only the kill -9 fault
injection (``fault.crash_point``) the durability battery drives."""
