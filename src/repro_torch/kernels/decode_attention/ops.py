"""Model-facing decode attention: the kernel on the card, its plain twin
on the CPU (the wrapper decides by the tensors' device)."""

from __future__ import annotations

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention,
)


def decode(q, k, v, lengths):
    """q [B, H, D], k/v [B, KVH, S, D], lengths [B] -> [B, H, D]."""
    return decode_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            lengths.to(q.device).int().contiguous())
