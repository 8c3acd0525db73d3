"""Model-facing decode attention: the kernel on the card, its plain twin
on the CPU (the wrapper decides by the tensors' device)."""

from __future__ import annotations

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention,
)


def decode(q, k, v, lengths, starts=None):
    """q [B, H, D], k/v [B, KVH, S, D], lengths [B] -> [B, H, D];
    ``starts`` [B] (a sliding window's first row of each sequence) or
    None."""
    if starts is not None:
        starts = starts.to(q.device).int().contiguous()
    return decode_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            lengths.to(q.device).int().contiguous(),
                            starts=starts)
