"""Uniform model API of the port: the transformer families (dense,
MoE, VLM and the encoder-only audio model, which has no decode step),
the hybrid (zamba) and the xLSTM families; the abstract parameters and
inputs of a dry-run cell (``param_shapes``, ``input_specs``: tensors on
``meta``, nothing allocated); and the bridge that carries parameters
between the port and the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.models import transformer, xlstm, zamba

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable                   # (cfg, gen) -> params
    forward_train: Callable          # (cfg, params, **batch) -> (logits, aux)
    init_cache: Optional[Callable]   # (cfg, B, Smax, dtype, device) -> cache
    decode_step: Optional[Callable]  # (cfg, params, tokens, cache, lengths)


def get_model(cfg: ArchConfig) -> ModelAPI:
    """The family's API, resolved as the JAX registry resolves it: zamba
    where ``hybrid_attn_every > 0``, xLSTM where ``cfg.xlstm`` is set, else
    the transformer (the encoder-only model has no cache and no decode
    step)."""
    if cfg.hybrid_attn_every > 0:
        return ModelAPI(zamba.init, zamba.forward_train, zamba.init_cache,
                        zamba.decode_step)
    if cfg.xlstm is not None:
        return ModelAPI(xlstm.init, xlstm.forward_train, xlstm.init_cache,
                        xlstm.decode_step)
    dec = None if cfg.encoder_only else transformer.decode_step
    cache = None if cfg.encoder_only else transformer.init_cache
    return ModelAPI(transformer.init, transformer.forward_train, cache, dec)


def param_shapes(cfg: ArchConfig) -> Dict:
    """The parameter tree on ``meta`` (no allocation) for dry runs: the
    JAX package's keys, nesting, shapes and dtypes."""
    return get_model(cfg).init(cfg, torch.Generator(), device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    """Meta stand-ins for every model input of this cell, shaped and
    typed as the JAX package's ``ShapeDtypeStruct``s.

    Modality frontends are stubs: audio provides frame embeddings at
    d_model, VLM provides InternViT patch features.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)
    if shape.kind in ("train", "prefill"):
        if cfg.encoder_only:
            return {
                "embeds": sds((B, S, cfg.d_model), torch.bfloat16),
                "labels": sds((B, S), i32),
                "mask": sds((B, S), torch.bool),
            }
        if cfg.vlm is not None:
            st = S - cfg.vlm.n_patches
            return {
                "tokens": sds((B, st), i32),
                "patches": sds((B, cfg.vlm.n_patches, cfg.vlm.patch_dim),
                               torch.bfloat16),
                "labels": sds((B, st), i32),
                "mask": sds((B, st), torch.bool),
            }
        return {
            "tokens": sds((B, S), i32),
            "labels": sds((B, S), i32),
            "mask": sds((B, S), torch.bool),
        }
    # decode: one new token against a cache of length S
    return {
        "tokens": sds((B,), i32),
        "lengths": sds((B,), i32),
        "cache": get_model(cfg).init_cache(cfg, B, S, device=META),
    }


def params_from_numpy(cfg: ArchConfig, tree: Dict, device=None) -> Dict:
    """The JAX parameter pytree (nested dicts of numpy arrays, layers
    stacked [L, ...], e.g. ``jax.device_get(params)``) as the port's
    parameters on ``device`` (default cuda): same keys (``moe/{router,
    w1, w3, w2, shared}``, ``projector/{w1, w2}`` and ``in_norm`` with
    the rest; zamba's ``mamba`` stack and ``shared`` block; xLSTM's
    ``mlstm`` and ``slstm`` stacks), same layouts, same dtypes.  Tuples
    cross as tuples, so a decode cache (xLSTM's sLSTM ``(c, n, h)``)
    crosses too."""
    from repro_torch.core.store import resolve_device

    get_model(cfg)
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(conv(v) for v in t)
        return torch.as_tensor(np.array(t), device=dev)
    return conv(tree)


def params_to_numpy(params: Dict) -> Dict:
    """The inverse of :func:`params_from_numpy`: the port's parameters as
    nested dicts of host numpy arrays, in the JAX package's layout (e.g.
    trained parameters handed to the JAX engine)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(params_to_numpy(v) for v in params)
    return params.detach().cpu().numpy()
