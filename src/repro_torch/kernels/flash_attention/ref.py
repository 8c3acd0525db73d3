"""Plain PyTorch twins of the flash-attention kernels, forward and
backward: ``flash_attention_ref`` and ``flash_attention_bwd_ref`` (the
``<kernel>_ref`` names the kernel-parity lint pairs with the wrappers),
also exported as ``attention_ref`` (the JAX package's oracle name) and
``attention_bwd_ref``.

``attention_ref`` computes what the hand-written forward kernel (and the
TPU kernel it replaces, ``src/repro/kernels/flash_attention/
flash_attention.py``) computes, with the same edge conventions: a masked
score is ``NEG_INF = -1e30`` (not ``-inf``), a masked probability is
forced to 0, and a row with no unmasked key (``l == 0``) outputs 0.  The
JAX oracle ``attention_ref`` gives the mean of v on such rows instead;
everywhere else the two agree.  With ``return_lse`` it also gives each
row's logsumexp of its scaled scores (natural log, fp32; ``-inf`` on a
row with no unmasked key), which the backward needs.

``attention_bwd_ref`` is the gradient, written out (no autograd): from
the forward's output ``o`` and ``lse`` it recomputes ``P = exp(S·scale -
lse)`` and gives dq, dk, dv with the GQA sum over each kv head's group.
A row with no unmasked key has ``P = 0`` and contributes nothing.  It is
the gradient ``jax.vjp`` takes of the JAX models' jnp attention
(``repro.models.common._sdpa``) wherever a row sees a key.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(Sq: int, Skv: int, causal: bool, window: int, device):
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= qi - ki < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q [B, H, Sq, D], k/v [B, KVH, Skv, D] (GQA: q head h reads kv head
    ``h // (H // KVH)``) -> [B, H, Sq, D] in q's dtype; fp32 arithmetic.
    With ``return_lse`` -> (out, lse [B, H, Sq] fp32)."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    group = H // KVH
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (1.0 / D ** 0.5), kx)
    mask = _mask(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx)
    out = (out / torch.where(l == 0, 1.0, l)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0, -torch.inf, m + torch.log(l))[..., 0]
    return out, lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0):
    """The gradient of :func:`flash_attention_ref`: (dq, dk, dv) in the
    dtypes of (q, k, v), fp32 arithmetic.  ``o`` and ``lse`` are the forward's
    output and logsumexp; ``do`` is the output's gradient."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    group = H // KVH
    scale = 1.0 / D ** 0.5
    qf, dof = q.float(), do.float()
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf * scale, kx)
    mask = _mask(Sq, Skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx)
    delta = (dof * o.float()).sum(-1, keepdim=True)      # rowsum(dO ⊙ O)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dkx = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dvx = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dkx.reshape(B, KVH, group, Skv, D).sum(2)
    dv = dvx.reshape(B, KVH, group, Skv, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


attention_ref = flash_attention_ref
attention_bwd_ref = flash_attention_bwd_ref
