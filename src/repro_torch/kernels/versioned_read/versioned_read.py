"""Snapshot version resolution (the paper's versioned read).

CUDA source: ``repro_torch/csrc/versioned_read.cu`` (design notes
there).  It replaces the Pallas TPU kernel ``versioned_read`` of
``src/repro/kernels/versioned_read/versioned_read.py``.  The wrapper
launches the kernel for a CUDA tensor and takes the plain twin in
``ref.py`` for a CPU tensor.  The lookup path walks its chains inside
``leaf_slots_at`` instead (one launch with the in-leaf rank).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.versioned_read.ref import versioned_read_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "uruv_versioned_read": (_P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P),
}


def versioned_read(vhead, snap_ts, ver_ts, ver_next, ver_value, *,
                   max_chain: int):
    """Per query, the value of the first version with ts <= snap_ts along
    the chain from ``vhead`` (at most ``max_chain`` steps), NOT_FOUND when
    there is none or it is a tombstone.  All int32; ``vhead`` [P],
    ``snap_ts`` a scalar or [P] (an ``expand``-ed scalar too: no copy),
    the version pools [MV]."""
    if _build.device_type(vhead) == "cpu":
        return versioned_read_ref(vhead, snap_ts, ver_ts, ver_next,
                                  ver_value, max_chain=max_chain)
    _build.require("versioned_read", vhead.device, torch.int32,
                   vhead=vhead, ver_ts=ver_ts, ver_next=ver_next,
                   ver_value=ver_value)
    P = vhead.shape[0]
    MV = ver_ts.shape[0]
    if (vhead.dim() != 1 or MV < 1 or ver_next.shape != (MV,)
            or ver_value.shape != (MV,) or max_chain < 0):
        raise ValueError("versioned_read: vhead [P], version pools [MV] "
                         "and max_chain >= 0 expected")
    stride = _build.snap_stride("versioned_read", snap_ts, P, vhead.device)
    out = torch.empty(P, dtype=torch.int32, device=vhead.device)
    if P == 0:
        return out
    lib = _build.load("versioned_read", _SIGNATURES)
    _build.launch_counts["versioned_read"] += 1
    rc = lib.uruv_versioned_read(
        vhead.data_ptr(), snap_ts.data_ptr(), stride, P, ver_ts.data_ptr(),
        ver_next.data_ptr(), ver_value.data_ptr(), MV, max_chain,
        out.data_ptr(), _build.stream_ptr(vhead))
    _build.check(rc, "versioned_read")
    return out
