"""Plain PyTorch twin of the flash-attention kernel.

It computes what the hand-written kernel (and the TPU kernel it replaces,
``src/repro/kernels/flash_attention/flash_attention.py``) computes, with
the same edge conventions: a masked score is ``NEG_INF = -1e30`` (not
``-inf``), a masked probability is forced to 0, and a row with no
unmasked key (``l == 0``) outputs 0.  The JAX oracle ``attention_ref``
gives the mean of v on such rows instead; everywhere else the two agree.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, H, Sq, D], k/v [B, KVH, Skv, D] (GQA: q head h reads kv head
    ``h // (H // KVH)``) -> [B, H, Sq, D] in q's dtype; fp32 arithmetic."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    group = H // KVH
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (1.0 / D ** 0.5), kx)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= qi - ki < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx)
    return (out / torch.where(l == 0, 1.0, l)).to(q.dtype)
