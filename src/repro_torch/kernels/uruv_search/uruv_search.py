"""Locate kernels: multi-level fat-node descent, in-leaf rank and the
flat-directory rank.

CUDA sources: ``repro_torch/csrc/uruv_search.cu`` (design notes there).
They replace the Pallas TPU kernels ``index_descend``, ``leaf_slots`` and
``search_positions`` of ``src/repro/kernels/uruv_search/uruv_search.py``.
``leaf_slots`` has two entries: on gathered rows (the TPU kernel's
signature) and :func:`leaf_slots_at`, in place on the leaf pool, which
the store's ``locate`` uses and which also walks each hit's version
chain in the same launch (the lookup's ``versioned_read``, fused).  A
wrapper launches its kernel for a CUDA tensor and takes the plain twin in
``ref.py`` for a CPU tensor; any other device raises.
"""

# uruvlint: disable-file=layering-index; reason: this IS the flat-directory rank kernel (the JAX twin lives in the rule's exempt repro/kernels/uruv_search)

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.uruv_search.ref import (
    index_descend_ref, leaf_slots_at_ref, leaf_slots_ref,
    search_positions_ref,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "uruv_index_descend": (ctypes.POINTER(ctypes.c_longlong), _I, _I, _I,
                           _P, _I, _P, _P),
    "uruv_leaf_slots": (_P, _I, _I, _P, _I, _P, _P, _P),
    "uruv_leaf_slots_read": (_P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P,
                             _P, _I, _I, _P, _P, _P, _P, _P),
    "uruv_search_positions": (_P, _I, _I, _P, _I, _P, _P),
}
_MAX_DEPTH = 32
_I32 = torch.int32


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
    dev = queries.device
    levels = (*level_keys, *level_child)
    # one pass over the levels: the checks of _build.require, then shapes
    for t in (queries, *levels):
        if t.dtype is not _I32 or t.device != dev or not t.is_contiguous():
            _build.require("index_descend", dev, _I32, queries=queries,
                           **{f"level{i}": x for i, x in enumerate(levels)})
    shapes = [t.shape for t in levels]
    F = shapes[0][1] if len(shapes[0]) == 2 else 0
    if F < 1 or queries.dim() != 1 or any(
            len(s) != 2 or s[1] != F or s != shapes[depth + l]
            for l, s in enumerate(shapes[:depth])):
        raise ValueError("index_descend: every level must be [C_l, F] and "
                         "queries [P]")
    P = queries.shape[0]
    out = torch.empty((3, P), dtype=_I32, device=dev)
    if P == 0:
        return out.unbind(0)
    ptrs = [t.data_ptr() for t in levels]
    caps = [s[0] for s in shapes[:depth]]
    buf = (ctypes.c_longlong * (3 * depth))(*ptrs, *caps)
    lib = _build.load("uruv_search", _SIGNATURES)
    _build.launch_counts["index_descend"] += 1
    rc = lib.uruv_index_descend(buf, depth, F, _build.vec_for(F, *ptrs),
                                queries.data_ptr(), P, out.data_ptr(),
                                _build.stream_ptr(queries))
    _build.check(rc, "index_descend")
    return out.unbind(0)


def leaf_slots(rows: torch.Tensor, queries: torch.Tensor):
    """In-leaf rank ``slot = #(row < q)`` and ``exists = slot < L &
    row[slot] == q`` for gathered leaf rows int32 [P, L]."""
    if _build.device_type(rows) == "cpu":
        return leaf_slots_ref(rows, queries)
    _build.require("leaf_slots", rows.device, _I32, rows=rows,
                   queries=queries)
    if rows.dim() != 2 or queries.shape != rows.shape[:1] or rows.shape[1] < 1:
        raise ValueError(f"leaf_slots: rows {tuple(rows.shape)} vs "
                         f"queries {tuple(queries.shape)}")
    P, L = rows.shape
    slot = torch.empty(P, dtype=_I32, device=rows.device)
    exists = torch.empty(P, dtype=torch.bool, device=rows.device)
    if P == 0:
        return slot, exists
    lib = _build.load("uruv_search", _SIGNATURES)
    _build.launch_counts["leaf_slots"] += 1
    rc = lib.uruv_leaf_slots(rows.data_ptr(), L,
                             _build.vec_for(L, rows.data_ptr()),
                             queries.data_ptr(), P, slot.data_ptr(),
                             exists.data_ptr(), _build.stream_ptr(rows))
    _build.check(rc, "leaf_slots")
    return slot, exists


def leaf_slots_at(leaf_keys: torch.Tensor, leaf_vhead: torch.Tensor,
                  leaf_id: torch.Tensor, queries: torch.Tensor,
                  snap_ts: torch.Tensor, ver_ts: torch.Tensor,
                  ver_next: torch.Tensor, ver_value: torch.Tensor, *,
                  max_chain: int):
    """The in-leaf rank in place on the leaf pool, with each hit's version
    chain walked in the same launch: for query i, row ``r =
    jax_index(leaf_id[i], ML)`` of ``leaf_keys`` int32 [ML, L] gives
    ``slot = #(row < q)`` and ``exists = slot < L & row[slot] == q``,
    ``vhead = leaf_vhead[r, min(slot, L - 1)]`` where it exists, else -1,
    and ``value``, the read of that chain through the version pools
    ``ver_ts``, ``ver_next``, ``ver_value`` (int32 [MV]) at ``snap_ts``
    (int32, a scalar or [P]), at most ``max_chain`` steps, NOT_FOUND where
    the key is absent: ``versioned_read`` of ``vhead`` fused into the
    rank, without the [P, L] gather of rows.  Returns (slot, exists,
    vhead, value); the launches count under ``leaf_slots_read``."""
    if _build.device_type(queries) == "cpu":
        return leaf_slots_at_ref(leaf_keys, leaf_vhead, leaf_id, queries,
                                 snap_ts, ver_ts, ver_next, ver_value,
                                 max_chain=max_chain)
    dev = queries.device
    _build.require("leaf_slots_at", dev, _I32, leaf_keys=leaf_keys,
                   leaf_vhead=leaf_vhead, leaf_id=leaf_id, queries=queries,
                   ver_ts=ver_ts, ver_next=ver_next, ver_value=ver_value)
    if (leaf_keys.dim() != 2 or leaf_vhead.shape != leaf_keys.shape
            or min(leaf_keys.shape) < 1 or queries.dim() != 1
            or leaf_id.shape != queries.shape):
        raise ValueError(f"leaf_slots_at: pools {tuple(leaf_keys.shape)} / "
                         f"{tuple(leaf_vhead.shape)}, leaf_id "
                         f"{tuple(leaf_id.shape)}, queries "
                         f"{tuple(queries.shape)}")
    ML, L = leaf_keys.shape
    P = queries.shape[0]
    MV = ver_ts.shape[0]
    if (ver_ts.dim() != 1 or MV < 1 or ver_next.shape != (MV,)
            or ver_value.shape != (MV,) or max_chain < 0):
        raise ValueError("leaf_slots_at: version pools [MV] and "
                         "max_chain >= 0 expected")
    stride = _build.snap_stride("leaf_slots_at", snap_ts, P, dev)
    out = torch.empty((3, P), dtype=_I32, device=dev)
    exists = torch.empty(P, dtype=torch.bool, device=dev)
    outs = (out[0], exists, out[1], out[2])
    if P == 0:
        return outs
    lk, lv = leaf_keys.data_ptr(), leaf_vhead.data_ptr()
    lib = _build.load("uruv_search", _SIGNATURES)
    _build.launch_counts["leaf_slots_read"] += 1
    rc = lib.uruv_leaf_slots_read(
        lk, lv, leaf_id.data_ptr(), ML, L, _build.vec_for(L, lk, lv),
        queries.data_ptr(), P, snap_ts.data_ptr(), stride,
        ver_ts.data_ptr(), ver_next.data_ptr(), ver_value.data_ptr(), MV,
        max_chain, out[0].data_ptr(), exists.data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), _build.stream_ptr(queries))
    _build.check(rc, "leaf_slots_at")
    return outs


def search_positions(dir_keys: torch.Tensor, queries: torch.Tensor):
    """Flat-directory rank ``max(#(dir_keys <= q) - 1, 0)`` for sorted
    ``dir_keys`` int32 [ML] and ``queries`` int32 [P]: int32 [P], the
    reference's ``searchsorted(dir_keys, q, side="right") - 1`` clamped
    at 0 (valid keys are below KEY_MAX - 1)."""
    if _build.device_type(queries) == "cpu":
        return search_positions_ref(dir_keys, queries)
    _build.require("search_positions", queries.device, torch.int32,
                   dir_keys=dir_keys, queries=queries)
    if dir_keys.dim() != 1 or queries.dim() != 1:
        raise ValueError(f"search_positions: dir_keys "
                         f"{tuple(dir_keys.shape)} and queries "
                         f"{tuple(queries.shape)} must be 1-D")
    P = queries.shape[0]
    pos = torch.empty(P, dtype=torch.int32, device=queries.device)
    if P == 0:
        return pos
    dk = dir_keys.data_ptr()
    lib = _build.load("uruv_search", _SIGNATURES)
    _build.launch_counts["search_positions"] += 1
    # windows start at multiples of 128 entries: only the base's alignment
    # picks the 16-byte variant
    rc = lib.uruv_search_positions(dk, dir_keys.shape[0],
                                   _build.vec_for(4, dk), queries.data_ptr(),
                                   P, pos.data_ptr(),
                                   _build.stream_ptr(queries))
    _build.check(rc, "search_positions")
    return pos
