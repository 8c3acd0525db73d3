"""Uniform model API of the port: the transformer families (dense,
MoE, VLM and the encoder-only audio model, which has no decode step),
plus the bridge that carries parameters between the port and the JAX
package."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable                   # (cfg, gen) -> params
    forward_train: Callable          # (cfg, params, **batch) -> (logits, aux)
    init_cache: Optional[Callable]   # (cfg, B, Smax, dtype, device) -> cache
    decode_step: Optional[Callable]  # (cfg, params, tokens, cache, lengths)


def get_model(cfg: ArchConfig) -> ModelAPI:
    """The transformer API for the dense, MoE, VLM and encoder-only
    families (the encoder has no cache and no decode step, as in JAX);
    the hybrid (zamba) and xLSTM families raise until their port lands
    (ROADMAP.md)."""
    for family, present in (("hybrid (zamba)", cfg.hybrid_attn_every > 0),
                            ("xLSTM", cfg.xlstm is not None)):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: the {family} family is not ported yet "
                "(see ROADMAP.md)")
    dec = None if cfg.encoder_only else transformer.decode_step
    cache = None if cfg.encoder_only else transformer.init_cache
    return ModelAPI(transformer.init, transformer.forward_train, cache, dec)


def params_from_numpy(cfg: ArchConfig, tree: Dict, device=None) -> Dict:
    """The JAX parameter pytree (nested dicts of numpy arrays, layers
    stacked [L, ...], e.g. ``jax.device_get(params)``) as the port's
    parameters on ``device`` (default cuda): same keys (``moe/{router,
    w1, w3, w2, shared}``, ``projector/{w1, w2}`` and ``in_norm`` with
    the rest), same layouts, same dtypes."""
    from repro_torch.core.store import resolve_device

    get_model(cfg)
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.as_tensor(np.array(t), device=dev)
    return conv(tree)


def params_to_numpy(params: Dict) -> Dict:
    """The inverse of :func:`params_from_numpy`: the port's parameters as
    nested dicts of host numpy arrays, in the JAX package's layout (e.g.
    trained parameters handed to the JAX engine)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
