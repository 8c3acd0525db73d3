"""Prefill attention kernels: causal / sliding-window GQA attention with an
online softmax, kv-length mask included, and its gradient.

CUDA sources: ``repro_torch/csrc/flash_attention.cu`` (the forward) and
``repro_torch/csrc/flash_attention_bwd.cu`` (the backward; design notes
in each).  The forward replaces the Pallas TPU kernel
``flash_attention`` of ``src/repro/kernels/flash_attention/
flash_attention.py``; the TPU package has no backward kernel (XLA
differentiates its jnp attention), and the backward computes that same
gradient.  The wrappers launch the kernels for CUDA tensors and take the
plain twins in ``ref.py`` for CPU tensors; on ``meta`` tensors (the dry
run) they check as for CUDA and return the kernels' output shapes through
the shape-only operators of ``kernels._meta``; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_ref,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": (_P,) * 10 + (_I,) * 9 + (_P,),
    "flash_attention_bwd_route": (_I, _I),
}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _shapes(kernel: str, q, k, v):
    """(B, H, KVH, Sq, Skv, D) after checking dtype, device and GQA."""
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"{kernel}: dtype {q.dtype} not in "
                        f"{sorted(map(str, DTYPE_CODE))}")
    _build.require(kernel, q.device, q.dtype, q=q, k=k, v=v)
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if (k.shape != (B, KVH, Skv, D) or v.shape != k.shape or KVH < 1
            or H % KVH or not 1 <= D <= MAX_HEAD_DIM):
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (need GQA "
                         f"H % KVH == 0 and D <= {MAX_HEAD_DIM})")
    return B, H, KVH, Sq, Skv, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q [B, H, Sq, D], k/v [B, KVH, Skv, D] -> [B, H, Sq, D] in q's dtype.

    ``window`` > 0 keeps keys with ``qi - ki < window`` (a static int);
    fp32 or bf16 inputs, fp32 accumulation.  ``return_lse`` also gives
    each row's logsumexp, fp32 [B, H, Sq] (what the backward needs);
    without it the kernel writes none.
    """
    dev = _build.device_type(q, meta=True)
    if dev == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             return_lse=return_lse)
    B, H, KVH, Sq, Skv, D = _shapes("flash_attention", q, k, v)
    if dev == "meta":
        from repro_torch.kernels import _meta

        out, lse = _meta.flash_attention(q, k, v, bool(causal), int(window),
                                         bool(return_lse))
        return (out, lse) if return_lse else out
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lib = _build.load("flash_attention", _SIGNATURES)
    _build.launch_counts["flash_attention"] += 1
    rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(),
                             lse.data_ptr() if return_lse else None,
                             B, H, KVH, Sq, Skv, D, int(bool(causal)),
                             int(window), DTYPE_CODE[q.dtype],
                             _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """The gradient of :func:`flash_attention`: (dq, dk, dv) shaped and
    typed as (q, k, v).  ``o`` and ``lse`` are the forward's output and
    logsumexp (``return_lse=True``), ``do`` the output's gradient.  One
    call is one counted launch (three kernels: rowsum(dO ⊙ O), dQ, and
    dK/dV summed over each kv head's group in the block, no atomics)."""
    dev = _build.device_type(q, meta=True)
    if dev == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    B, H, KVH, Sq, Skv, D = _shapes("flash_attention_bwd", q, k, v)
    _build.require("flash_attention_bwd", q.device, q.dtype, o=o, do=do)
    _build.require("flash_attention_bwd", q.device, torch.float32, lse=lse)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(
            f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)} "
            f"and lse {tuple(lse.shape)} must match q {tuple(q.shape)}")
    if dev == "meta":
        from repro_torch.kernels import _meta

        return _meta.flash_attention_bwd(q, k, v, o, lse, do, bool(causal),
                                         int(window))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    _build.launch_counts["flash_attention_bwd"] += 1
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, KVH, Sq, Skv, D,
        int(bool(causal)), int(window), DTYPE_CODE[q.dtype],
        _build.stream_ptr(q))
    _build.check(rc, "flash_attention_bwd")
    return dq, dk, dv


def _bwd_route(dtype, D: int) -> str:
    """The kernels a CUDA :func:`flash_attention_bwd` call of this dtype
    and head dim runs, as the C entry dispatches: ``"tc"`` (tensor cores)
    or ``"scalar"``."""
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    return ("tc" if lib.flash_attention_bwd_route(int(D), DTYPE_CODE[dtype])
            else "scalar")
