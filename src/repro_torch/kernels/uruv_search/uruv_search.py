"""Locate kernels: multi-level fat-node descent and in-leaf rank.

CUDA sources: ``repro_torch/csrc/uruv_search.cu`` (design notes there).
They replace the Pallas TPU kernels ``index_descend`` and ``leaf_slots``
of ``src/repro/kernels/uruv_search/uruv_search.py``.  A wrapper launches
its kernel for a CUDA tensor and takes the plain twin in ``ref.py`` for
a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.uruv_search.ref import (
    index_descend_ref, leaf_slots_ref,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "uruv_index_descend": (ctypes.POINTER(ctypes.c_longlong),
                           ctypes.POINTER(ctypes.c_longlong),
                           ctypes.POINTER(ctypes.c_int), _I, _I, _P, _I,
                           _P, _P, _P, _P),
    "uruv_leaf_slots": (_P, _P, _I, _I, _P, _P, _P),
}
_MAX_DEPTH = 32


def index_descend(level_keys, level_child, queries: torch.Tensor):
    """Root->leaf descent over the fat-node index: returns (bottom_node,
    bottom_slot, leaf_id) of the last separator <= q.

    ``level_keys`` / ``level_child``: per-level int32 [C_l, F] tensors,
    level 0 the bottom; ``queries`` int32 [P].
    """
    if _build.device_type(queries) == "cpu":
        return index_descend_ref(level_keys, level_child, queries)
    depth = len(level_keys)
    if not 1 <= depth <= _MAX_DEPTH or len(level_child) != depth:
        raise ValueError(f"index_descend: depth {depth} not in [1, "
                         f"{_MAX_DEPTH}] or keys/child levels differ")
    F = level_keys[0].shape[1]
    _build.require("index_descend", queries.device, torch.int32,
                   queries=queries,
                   **{f"keys{l}": t for l, t in enumerate(level_keys)},
                   **{f"child{l}": t for l, t in enumerate(level_child)})
    for k, c in zip(level_keys, level_child):
        if k.dim() != 2 or k.shape[1] != F or c.shape != k.shape:
            raise ValueError("index_descend: every level must be [C_l, F]")
    P = queries.shape[0]
    out = [torch.empty(P, dtype=torch.int32, device=queries.device)
           for _ in range(3)]
    if P == 0:
        return tuple(out)
    lib = _build.load("uruv_search", _SIGNATURES)
    kp = (ctypes.c_longlong * depth)(*[t.data_ptr() for t in level_keys])
    cp = (ctypes.c_longlong * depth)(*[t.data_ptr() for t in level_child])
    caps = (ctypes.c_int * depth)(*[t.shape[0] for t in level_keys])
    _build.launch_counts["index_descend"] += 1
    rc = lib.uruv_index_descend(kp, cp, caps, depth, F, queries.data_ptr(),
                                P, out[0].data_ptr(), out[1].data_ptr(),
                                out[2].data_ptr(), _build.stream_ptr(queries))
    _build.check(rc, "index_descend")
    return tuple(out)


def leaf_slots(rows: torch.Tensor, queries: torch.Tensor):
    """In-leaf rank ``slot = #(row < q)`` and ``exists = slot < L &
    row[slot] == q`` for gathered leaf rows int32 [P, L]."""
    if _build.device_type(rows) == "cpu":
        return leaf_slots_ref(rows, queries)
    _build.require("leaf_slots", rows.device, torch.int32,
                   rows=rows, queries=queries)
    P, L = rows.shape
    if queries.shape != (P,) or L < 1:
        raise ValueError(f"leaf_slots: rows {tuple(rows.shape)} vs "
                         f"queries {tuple(queries.shape)}")
    slot = torch.empty(P, dtype=torch.int32, device=rows.device)
    exists = torch.empty(P, dtype=torch.bool, device=rows.device)
    if P == 0:
        return slot, exists
    lib = _build.load("uruv_search", _SIGNATURES)
    _build.launch_counts["leaf_slots"] += 1
    rc = lib.uruv_leaf_slots(rows.data_ptr(), queries.data_ptr(), P, L,
                             slot.data_ptr(), exists.data_ptr(),
                             _build.stream_ptr(rows))
    _build.check(rc, "leaf_slots")
    return slot, exists
