"""The store's hot-path primitives, dispatched on the tensor's device.

``locate`` (fat-node descent + in-leaf rank, with the versioned chain
read in the rank's launch), ``resolve`` (versioned chain read) and
``range_scan`` (fused leaf-window gather + versioned resolve) each go
through a kernel wrapper of ``repro_torch.kernels``: for a CUDA tensor
the wrapper launches the hand-written kernel (or raises), for a CPU
tensor it runs the plain PyTorch twin.  There is no
backend switch and no fallback: the device of the store decides.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.uruv_range.uruv_range import range_scan as _range_scan
from repro_torch.kernels.uruv_search.uruv_search import (
    index_descend, leaf_slots_at,
)
from repro_torch.kernels.versioned_read.versioned_read import versioned_read


def descend(index, queries: torch.Tensor):
    """Root->leaf F-way descent over ``repro_torch.core.index``: returns
    (bottom_node, bottom_slot, leaf_id) of the last separator <= q."""
    return index_descend(index.node_keys, index.node_child, queries)


def _snapshot(snap_ts, like: torch.Tensor) -> torch.Tensor:
    """``snap_ts`` as int32 on ``like``'s device, as the kernels take it:
    a scalar, or one per query with a stride of 0 or 1.  Only a [P] view
    with any other stride is copied."""
    snap = torch.as_tensor(snap_ts, dtype=torch.int32, device=like.device)
    if snap.dim() == 1 and snap.numel() > 1 and snap.stride(0) not in (0, 1):
        snap = snap.contiguous()
    return snap


def locate(index, leaf_keys, leaf_vhead, queries: torch.Tensor, snap_ts,
           versions, *, max_chain: int):
    """Full traversal and versioned read: (bnode, bslot, leaf_id, slot,
    exists, vhead, value).  ``(bnode, bslot)`` is the bottom index entry
    covering the query; ``vhead`` is -1 where the key is absent;
    ``value`` is the query's value at ``snap_ts`` (scalar or [P]) along
    the chain through ``versions = (ver_ts, ver_next, ver_value)``,
    NOT_FOUND where the key is absent.  Two kernels on the card: the
    descent, then the in-leaf rank, which reads each query's leaf row in
    place and walks the hit's chain in the same launch."""
    bnode, bslot, leaf_id = descend(index, queries)
    return (bnode, bslot, leaf_id,
            *leaf_slots_at(leaf_keys, leaf_vhead, leaf_id, queries,
                           _snapshot(snap_ts, queries), *versions,
                           max_chain=max_chain))


def resolve(vhead, snap_ts, ver_ts, ver_next, ver_value, *, max_chain: int):
    """Versioned read over the chain pool; ``snap_ts`` is a scalar or one
    per ``vhead`` entry."""
    return versioned_read(vhead, _snapshot(snap_ts, vhead), ver_ts, ver_next,
                          ver_value, max_chain=max_chain)


def range_scan(lids, pvalid, k1, k2, snap_ts, leaf_keys, leaf_vhead,
               leaf_count, ver_ts, ver_next, ver_value, *, max_chain: int):
    """Candidate keys/values for Q leaf windows, each [Q, S*L]; non-hits
    are (KEY_MAX, NOT_FOUND), tombstones already dropped."""
    return _range_scan(lids, pvalid, k1, k2, snap_ts, leaf_keys, leaf_vhead,
                       leaf_count, ver_ts, ver_next, ver_value,
                       max_chain=max_chain)
