"""Model-facing prefill attention: the kernels on the card, their plain
twins on the CPU (the wrappers decide by the tensors' device).

Under autograd (an input requires a gradient and grad mode is on) the
call is a ``torch.autograd.Function``: the forward kernel also writes
each row's logsumexp, and the backward is the hand-written backward
kernel (``flash_attention_bwd``) on the card, ``attention_bwd_ref`` on
the CPU.  Otherwise it is the forward alone, which writes no logsumexp.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_bwd,
)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, H, Sq, D], k/v [B, KVH, Skv, D] -> [B, H, Sq, D]."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, bool(causal), int(window))
    return flash_attention(q, k, v, causal=causal, window=int(window))
