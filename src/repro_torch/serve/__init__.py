"""Serving layer of the port: the pipelined admission ``coalescer`` over a
``Uruv`` client and the continuous-batching LM ``engine``."""
