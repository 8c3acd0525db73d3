"""Plain PyTorch twins of the uruv_search kernels (device-agnostic).

Gathers follow the JAX reference's index semantics (a negative index
wraps once, then clamps), so these agree with the JAX oracles bit for bit
even on random tables.
"""

from __future__ import annotations

import torch

from repro_torch.core._ops import jax_index
from repro_torch.core.ref import KEY_MAX


def index_descend_ref(level_keys, level_child, queries: torch.Tensor):
    """(bottom_node, bottom_slot, leaf_id) of the last separator <= q:
    a root-to-leaf F-way descent, level ``len(level_keys) - 1`` first."""
    q = queries
    cur = torch.zeros_like(q)
    slot = torch.zeros_like(q)
    nxt = cur
    for l in range(len(level_keys) - 1, -1, -1):
        r = jax_index(cur, level_keys[l].shape[0])
        rows = level_keys[l][r]
        cnt = ((rows <= q[:, None]) & (rows < KEY_MAX)).sum(1, dtype=torch.int32)
        slot = (cnt - 1).clamp_min(0)
        nxt = level_child[l][r, slot]
        if l > 0:
            cur = nxt
    return cur, slot, nxt


def leaf_slots_ref(rows: torch.Tensor, queries: torch.Tensor):
    """In-leaf rank ``#(row < q)`` and membership for gathered rows [P, L]."""
    L = rows.shape[1]
    slot = (rows < queries[:, None]).sum(1, dtype=torch.int32)
    hit = rows.gather(1, slot.clamp_max(L - 1).long()[:, None])[:, 0]
    return slot, (slot < L) & (hit == queries)
