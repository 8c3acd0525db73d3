"""The least bytes a plan's work needs, and the card's peaks.

The count is a function of the operations alone, never of the kernels'
arguments, so a kernel that is fused, split or removed leaves it as it
was.  It is a bound that no implementation can beat:

* each distinct CRUD key of a plan: one 32-byte sector of leaf keys and
  one of version data (a key is located and its version read or written
  once, however many ops of the plan touch it);
* each (key, value) pair a RANGE answers: its key, value and version
  timestamp read once (12 bytes) and the pair written out (8 bytes);
* the plan itself: 12 bytes an op in (code, key, value), 4 out (result).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from uruvbench.reference import OP_NOP, OP_RANGE

SECTOR = 32
PAIR_READ, PAIR_WRITE = 12, 8
OP_IN, OP_OUT = 12, 4
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def plan_min_bytes(codes, keys, range_pairs: int) -> int:
    codes = np.asarray(codes)
    real = codes != OP_NOP
    crud = real & (codes != OP_RANGE)
    distinct = len(np.unique(np.asarray(keys)[crud]))
    n = int(real.sum())
    return (2 * SECTOR * distinct + (PAIR_READ + PAIR_WRITE) * int(range_pairs)
            + (OP_IN + OP_OUT) * n)


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    """The published HBM bandwidth of the card named ``kind``, or None
    for a card the table does not hold."""
    peak = json.loads(PEAKS.read_text()).get(kind)
    return None if peak is None else float(peak["hbm_bytes_per_s"])
