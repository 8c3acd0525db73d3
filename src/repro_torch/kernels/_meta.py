"""Shape-only operators for the attention kernels on ``meta`` tensors.

The dry run (``repro_torch.launch.dryrun``) runs a model's real step on
``meta`` tensors: shapes and dtypes flow, nothing is allocated or
computed.  There the attention wrappers (``flash_attention``,
``flash_attention_bwd``, ``decode_attention``) run their usual shape,
dtype and GQA checks and then call one of these operators, which returns
tensors of the kernel's output shapes and dtypes as one operation that a
``TorchDispatchMode`` sees.  Each carries a FLOP formula (registered
with ``torch.utils.flop_counter``) for the work its kernel does, counted
as PERF.md's bounds count it:

  forward   4·B·H·D FLOPs a (query, key) pair the mask keeps (causal
            and window rules of ``ref._mask``);
  backward  2.5 × the forward's;
  decode    4·B·H·S·D, S the cache rows (``launch.roofline.model_flops``
            counts decode attention so).

Nothing materialises the S×S scores, and the plain twins never run on
``meta``: at 32k tokens their scores alone would be terabytes that the
kernels never hold.  The CUDA and CPU branches of the wrappers never
import this module.  Each operator's own implementation raises: it has
no other device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula


def unmasked_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash kernel's mask keeps: ``qi >= ki``
    when causal, ``qi - ki < window`` when windowed (``ref._mask``)."""
    qi = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qi, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qi - window + 1, 0) if window > 0 else np.zeros(Sq,
                                                                     np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _meta_only(name: str):
    raise RuntimeError(f"repro_torch::{name} is shape-only: meta tensors "
                       "only (the wrapper launches the kernel on cuda)")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int, return_lse: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out like q, lse [B, H, Sq] fp32, or [0] without ``return_lse``)."""
    _meta_only("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal, window, return_lse):
    B, H, Sq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, Sq) if return_lse else (0,),
                        dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd",
                         mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool, window: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) shaped and typed as (q, k, v)."""
    _meta_only("flash_attention_bwd")


@flash_attention_bwd.register_fake
def _(q, k, v, o, lse, do, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, starts: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out like q, m, l [B, H, 1] fp32): what the kernel writes."""
    _meta_only("decode_attention")


@decode_attention.register_fake
def _(q, k, v, lengths, starts):
    B, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, 1), dtype=torch.float32),
            q.new_empty((B, H, 1), dtype=torch.float32))


def _fwd_flops(q_shape, k_shape, causal: bool, window: int) -> int:
    B, H, Sq, D = q_shape
    return 4 * B * H * D * unmasked_pairs(Sq, k_shape[2], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, return_lse, *args,
      out_shape=None, **kwargs) -> int:
    return _fwd_flops(q_shape, k_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal,
      window, *args, out_shape=None, **kwargs) -> int:
    return 5 * _fwd_flops(q_shape, k_shape, causal, window) // 2


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _(q_shape, k_shape, v_shape, lengths_shape, starts_shape, *args,
      out_shape=None, **kwargs) -> int:
    B, H, D = q_shape
    return 4 * B * H * k_shape[2] * D
