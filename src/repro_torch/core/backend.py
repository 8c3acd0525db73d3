"""The store's hot-path primitives, dispatched on the tensor's device.

``locate`` (fat-node descent + in-leaf rank), ``resolve`` (versioned
chain read) and ``range_scan`` (fused leaf-window gather + versioned
resolve) each go through a kernel wrapper of ``repro_torch.kernels``:
for a CUDA tensor the wrapper launches the hand-written kernel (or
raises), for a CPU tensor it runs the plain PyTorch twin.  There is no
backend switch and no fallback: the device of the store decides.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.uruv_range.uruv_range import range_scan as _range_scan
from repro_torch.kernels.uruv_search.uruv_search import (
    index_descend, leaf_slots,
)
from repro_torch.kernels.versioned_read.versioned_read import versioned_read


def descend(index, queries: torch.Tensor):
    """Root->leaf F-way descent over ``repro_torch.core.index``: returns
    (bottom_node, bottom_slot, leaf_id) of the last separator <= q."""
    return index_descend(index.node_keys, index.node_child, queries)


def locate(index, leaf_keys, leaf_vhead, queries: torch.Tensor):
    """Full traversal: (bnode, bslot, leaf_id, slot, exists, vhead).
    ``(bnode, bslot)`` is the bottom index entry covering the query;
    ``vhead`` is -1 where the key is absent."""
    L = leaf_keys.shape[1]
    bnode, bslot, leaf_id = descend(index, queries)
    slot, exists = leaf_slots(leaf_keys[leaf_id], queries)
    vhead = torch.where(exists, leaf_vhead[leaf_id, slot.clamp_max(L - 1)], -1)
    return bnode, bslot, leaf_id, slot, exists, vhead


def resolve(vhead, snap_ts, ver_ts, ver_next, ver_value, *, max_chain: int):
    """Versioned read over the chain pool; ``snap_ts`` broadcasts to
    ``vhead``."""
    snap = torch.as_tensor(snap_ts, dtype=torch.int32, device=vhead.device)
    return versioned_read(vhead, snap.expand(vhead.shape).contiguous(),
                          ver_ts, ver_next, ver_value, max_chain=max_chain)


def range_scan(lids, pvalid, k1, k2, snap_ts, leaf_keys, leaf_vhead,
               leaf_count, ver_ts, ver_next, ver_value, *, max_chain: int):
    """Candidate keys/values for Q leaf windows, each [Q, S*L]; non-hits
    are (KEY_MAX, NOT_FOUND), tombstones already dropped."""
    return _range_scan(lids, pvalid, k1, k2, snap_ts, leaf_keys, leaf_vhead,
                       leaf_count, ver_ts, ver_next, ver_value,
                       max_chain=max_chain)
