"""Prefill attention kernel: causal / sliding-window GQA attention with an
online softmax, kv-length mask included.

CUDA source: ``repro_torch/csrc/flash_attention.cu`` (design notes
there).  It replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention/flash_attention.py``.  The wrapper
launches the kernel for a CUDA tensor and takes the plain twin in
``ref.py`` for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P),
}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, H, Sq, D], k/v [B, KVH, Skv, D] -> [B, H, Sq, D] in q's dtype.

    ``window`` > 0 keeps keys with ``qi - ki < window`` (a static int);
    fp32 or bf16 inputs, fp32 accumulation.
    """
    if _build.device_type(q) == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{sorted(map(str, DTYPE_CODE))}")
    _build.require("flash_attention", q.device, q.dtype, q=q, k=k, v=v)
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if (k.shape != (B, KVH, Skv, D) or v.shape != k.shape or KVH < 1
            or H % KVH or not 1 <= D <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (need GQA "
                         f"H % KVH == 0 and D <= {MAX_HEAD_DIM})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _SIGNATURES)
    _build.launch_counts["flash_attention"] += 1
    rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B, H, KVH, Sq, Skv, D,
                             int(bool(causal)), int(window),
                             DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    return out
