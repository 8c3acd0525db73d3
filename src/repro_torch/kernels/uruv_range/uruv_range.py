"""Fused range-scan candidate phase (paper Sec 3.4 / Fig. 11).

CUDA source: ``repro_torch/csrc/uruv_range.cu`` (design notes there).
It replaces the Pallas TPU kernel ``range_scan`` of
``src/repro/kernels/uruv_range/uruv_range.py``.  The wrapper launches the
kernel for a CUDA tensor and takes the plain twin in ``ref.py`` for a CPU
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.uruv_range.ref import range_scan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "uruv_range_scan": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                        _P, _P, _P, _I, _I, _P, _P, _P),
}


def range_scan(lids, pvalid, k1, k2, snap_ts, leaf_keys, leaf_vhead,
               leaf_count, ver_ts, ver_next, ver_value, *, max_chain: int):
    """Candidate phase of Q range queries: (cand_keys, cand_vals), each
    int32 [Q, S*L].

    ``lids`` int32 [Q, S] are the leaves of each query's window and
    ``pvalid`` bool [Q, S] masks non-participating slots; ``k1``, ``k2``
    and ``snap_ts`` are int32 [Q].  Hits carry (key, value at the query's
    snapshot); non-hits are (KEY_MAX, NOT_FOUND), tombstones dropped.
    """
    if _build.device_type(lids) == "cpu":
        return range_scan_ref(lids, pvalid, k1, k2, snap_ts, leaf_keys,
                              leaf_vhead, leaf_count, ver_ts, ver_next,
                              ver_value, max_chain=max_chain)
    dev = lids.device
    _build.require("range_scan", dev, torch.int32, lids=lids, k1=k1, k2=k2,
                   snap_ts=snap_ts, leaf_keys=leaf_keys,
                   leaf_vhead=leaf_vhead, leaf_count=leaf_count,
                   ver_ts=ver_ts, ver_next=ver_next, ver_value=ver_value)
    _build.require("range_scan", dev, torch.bool, pvalid=pvalid)
    Q, S = lids.shape
    ML, L = leaf_keys.shape
    MV = ver_ts.shape[0]
    if (pvalid.shape != (Q, S) or any(t.shape != (Q,) for t in (k1, k2, snap_ts))
            or leaf_vhead.shape != (ML, L) or leaf_count.shape != (ML,)
            or ver_next.shape != (MV,) or ver_value.shape != (MV,)
            or min(ML, L, MV) < 1):
        raise ValueError("range_scan: argument shapes disagree")
    out_keys = torch.empty((Q, S * L), dtype=torch.int32, device=dev)
    out_vals = torch.empty((Q, S * L), dtype=torch.int32, device=dev)
    if Q * S == 0:
        return out_keys, out_vals
    lib = _build.load("uruv_range", _SIGNATURES)
    _build.launch_counts["range_scan"] += 1
    rc = lib.uruv_range_scan(
        lids.data_ptr(), pvalid.data_ptr(), k1.data_ptr(), k2.data_ptr(),
        snap_ts.data_ptr(), Q, S, leaf_keys.data_ptr(),
        leaf_vhead.data_ptr(), leaf_count.data_ptr(), ML, L,
        ver_ts.data_ptr(), ver_next.data_ptr(), ver_value.data_ptr(), MV,
        max_chain, out_keys.data_ptr(), out_vals.data_ptr(),
        _build.stream_ptr(lids))
    _build.check(rc, "range_scan")
    return out_keys, out_vals
