"""Decode attention kernel: one new token per sequence against a KV cache
with per-sequence lengths, optionally with the ``(m, l)`` softmax stats.

CUDA source: ``repro_torch/csrc/decode_attention.cu`` (design notes
there).  It replaces the Pallas TPU kernel ``decode_attention`` of
``src/repro/kernels/decode_attention/decode_attention.py``.  The wrapper
launches the kernel for a CUDA tensor and takes the plain twin in
``ref.py`` for a CPU tensor; on a ``meta`` tensor (the dry run) it checks
as for CUDA and returns the kernel's output shapes through the
shape-only operator of ``kernels._meta``; any other device raises.  On
the card the cache is split into chunks of rows (:func:`_split_schedule`),
scored by separate blocks and combined by a second launch from the same
C entry; one wrapper call counts once in ``launch_counts``.  A sliding window
(gemma3's local layers) is a per-sequence first row, ``starts``, that the
kernel reads on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _I, _P),
}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 32          # q heads per kv head, scored together in a block
TARGET_BLOCKS = 256     # about two blocks per SM of the H100's 132
TILE_ROWS = 32          # rows of the kernel's tile: a chunk is whole tiles


def _split_schedule(S: int, n_kv: int) -> tuple:
    """``(n_splits, chunk)`` for a cache of ``S`` rows and ``n_kv`` = B·KVH
    (batch × kv heads): the kernel's grid is ``(n_splits, KVH, B)``, split
    ``i`` taking rows ``[i·chunk, (i+1)·chunk)``.  A function of the
    shapes alone, so the wrapper never reads ``lengths`` on the host;
    ``chunk`` is a whole number of tiles and ``n_splits · chunk >= S``."""
    want = -(-TARGET_BLOCKS // max(n_kv, 1))     # splits per (b, kv head)
    tiles = -(-S // TILE_ROWS)
    chunk = max(1, tiles // want) * TILE_ROWS     # so n_splits >= want
    return max(1, -(-S // chunk)), chunk


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     starts: Optional[torch.Tensor] = None,
                     return_stats: bool = False):
    """q [B, H, D], k/v [B, KVH, S, D], lengths [B] int32 (a length past S
    counts as S) -> out [B, H, D] in q's dtype, plus ``m``, ``l`` [B, H, 1]
    fp32 with ``return_stats``.  ``starts`` [B] int32, when given, is each
    sequence's first row (a sliding window): rows [starts[b], lengths[b])
    are attended to."""
    dev = _build.device_type(q, meta=True)
    if dev == "cpu":
        return decode_attention_ref(q, k, v, lengths, starts=starts,
                                    return_stats=return_stats)
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"decode_attention: dtype {q.dtype} not in "
                        f"{sorted(map(str, DTYPE_CODE))}")
    _build.require("decode_attention", q.device, q.dtype, q=q, k=k, v=v)
    _build.require("decode_attention", q.device, torch.int32,
                   lengths=lengths)
    if starts is not None:
        _build.require("decode_attention", q.device, torch.int32,
                       starts=starts)
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    if (k.shape != (B, KVH, S, D) or v.shape != k.shape or KVH < 1
            or H % KVH or H // KVH > MAX_GROUP or lengths.shape != (B,)
            or (starts is not None and starts.shape != (B,))
            or not 1 <= D <= MAX_HEAD_DIM):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"lengths {tuple(lengths.shape)} (need H % KVH == 0, "
            f"H / KVH <= {MAX_GROUP}, D <= {MAX_HEAD_DIM})")
    if dev == "meta":
        from repro_torch.kernels import _meta

        out, m, l = _meta.decode_attention(q, k, v, lengths, starts)
        return (out, m, l) if return_stats else out
    out = torch.empty_like(q)
    m = torch.empty(B, H, 1, dtype=torch.float32, device=q.device)
    l = torch.empty(B, H, 1, dtype=torch.float32, device=q.device)
    if B:
        n_splits, chunk = _split_schedule(S, B * KVH)
        # per split (acc [D], m, l) of every (b, q head), combined on the card
        part = (torch.empty(B * H * n_splits * (D + 2), dtype=torch.float32,
                            device=q.device) if n_splits > 1 else None)
        lib = _build.load("decode_attention", _SIGNATURES)
        _build.launch_counts["decode_attention"] += 1
        rc = lib.decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  lengths.data_ptr(),
                                  None if starts is None
                                  else starts.data_ptr(), out.data_ptr(),
                                  m.data_ptr(), l.data_ptr(),
                                  None if part is None else part.data_ptr(),
                                  B, H, KVH, S, D, chunk, n_splits,
                                  DTYPE_CODE[q.dtype], _build.stream_ptr(q))
        _build.check(rc, "decode_attention")
    if return_stats:
        return out, m, l
    return out
