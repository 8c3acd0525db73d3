"""Plain PyTorch twin of the decode-attention kernel.

It computes what the hand-written kernel (and the TPU kernel it replaces,
``src/repro/kernels/decode_attention/decode_attention.py``) computes:
one query token per sequence against the first ``lengths[b]`` rows of a
KV cache, with ``NEG_INF = -1e30`` masking, masked probabilities forced
to 0 and a sequence of length 0 giving 0.  A length past the cache
counts as the whole cache.  With ``starts`` (a sliding window) only
rows ``[starts[b], lengths[b])`` are attended to; a sequence left with no
row gives 0 like a length of 0.  With ``return_stats`` it also returns the
running max ``m`` and sum ``l`` ([B, H, 1], fp32) for a split-KV combine.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *,
                         starts: Optional[torch.Tensor] = None,
                         return_stats: bool = False):
    """q [B, H, D], k/v [B, KVH, S, D], lengths [B] int32, ``starts`` [B]
    int32 or None -> [B, H, D] in q's dtype (plus ``(m, l)`` with
    ``return_stats``)."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    group = H // KVH
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float() * (1.0 / D ** 0.5), kx)
    rows = torch.arange(S, device=q.device)[None, None, :]
    mask = rows < lengths.to(q.device)[:, None, None]
    if starts is not None:
        mask &= rows >= starts.to(q.device)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhk,bhkd->bhd", p, vx)
    out = (out / torch.where(l == 0, 1.0, l)).to(q.dtype)
    if return_stats:
        return out, m, l
    return out
