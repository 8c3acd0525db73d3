"""Sentinels and op codes of the Uruv ADT, for the PyTorch port.

The port keeps its own copy of these values rather than importing the JAX
package: it must run where JAX is not installed.  They are bit-identical
to the JAX package's domain module, so stores carried across with
``repro_torch.core.store.from_numpy`` mean the same thing on both sides.

KEY_MAX masks out and pads, KEY_MAX - 1 is the kernels' internal pad
sentinel, and user keys end at KEY_DOMAIN_HI.
"""

from __future__ import annotations

# the one place the port spells the key-sentinel family as a literal
KEY_MAX = 2**31 - 1  # uruvlint: disable=sentinel-literal; reason: the port's own domain module (it may not import the JAX one)
KEY_DOMAIN_HI = KEY_MAX - 2  # largest user-visible key
KEY_MIN = -(2**31)           # separator of the leftmost leaf
TOMBSTONE = -(2**31) + 1     # paper's tombstone value
NOT_FOUND = -1               # paper: SEARCH returns -1 when absent

OP_INSERT = 0
OP_DELETE = 1
OP_SEARCH = 2
OP_NOP = 3
OP_RANGE = 4                 # RANGEQUERY: key = k1, value = k2; result = count
