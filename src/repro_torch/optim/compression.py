"""Gradient compression for data-parallel all-reduce.

A port of the JAX package's ``repro.optim.compression``: two production
tricks with error feedback (EF keeps convergence), over trees of tensors
(``repro_torch.optim.adamw.tree_map``):

  * top-k sparsification — keep the k largest-|g| entries per leaf; the
    residual feeds back into the next step's gradient.
  * int8 quantization — per-leaf absmax scaling.

``compress_grads`` simulates the wire format (compress, then
decompress); :func:`compressed_psum` is the wire-level int8 all-reduce of
a data-parallel loop over a ``torch.distributed`` group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.distributed import collectives as C
from repro_torch.optim.adamw import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"          # none | topk | int8
    topk_ratio: float = 0.01    # keep top 1%


def init_error(params) -> Dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(cfg: CompressionConfig, grads, error):
    """Returns (compressed-then-decompressed grads, new error feedback)."""
    if cfg.kind == "none":
        return grads, error
    if cfg.kind not in ("topk", "int8"):
        raise ValueError(cfg.kind)

    def one(g, e):
        g = g.float() + e
        if cfg.kind == "topk":
            k = max(1, int(g.numel() * cfg.topk_ratio))
            flat = g.reshape(-1)
            thresh = torch.topk(flat.abs(), k).values[-1]
            keep = flat.abs() >= thresh
            sent = torch.where(keep, flat, 0.0).reshape(g.shape)
        else:
            scale = g.abs().max() / 127.0 + 1e-12
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            sent = q.float() * scale
        return sent, g - sent

    residuals = []

    def sent_of(g, e):
        sent, resid = one(g, e)
        residuals.append(resid)
        return sent

    sent = tree_map(sent_of, grads, error)
    it = iter(residuals)                 # tree_map visits leaves in order
    return sent, tree_map(lambda _: next(it), grads)


def compressed_psum(g: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``g`` over ``group`` with int8 values on the wire (the
    JAX package's ``compressed_psum``): a shared scale (the group's
    largest ``max|g| / 127``), each member's ``g`` rounded to int8 steps
    of it, an int32 sum, and the sum times the scale over the group's
    size."""
    scale = g.abs().max() / 127.0 + 1e-12
    scale = C.pmax(scale.reshape(1), group)[0]      # shared scale
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int32)
    total = C.psum(q, group)
    return total.float() * scale / float(C.axis_size(group))
