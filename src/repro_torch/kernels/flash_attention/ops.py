"""Model-facing prefill attention: the kernel on the card, its plain twin
on the CPU (the wrapper decides by the tensors' device)."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, H, Sq, D], k/v [B, KVH, Skv, D] -> [B, H, Sq, D]."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=int(window))
