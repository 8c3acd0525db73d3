"""Transformer stack, dense family.

A port of the JAX package's ``repro.models.transformer`` for the dense
family.  Layers are *stacked* as there: every per-layer parameter carries
a leading [L] axis.  ``lax.scan`` over layers becomes a Python loop, and
each layer's attention window (``layer_windows``) is a plain ``int``, as
the flash kernel takes it.

API:
  init(cfg, gen)                      -> params
  forward_train(cfg, params, tokens)  -> (logits [B, S, V], aux)
  prefill(cfg, params, tokens, Smax)  -> (logits [B, S, V], cache)
  init_cache(cfg, B, Smax, ...)       -> {"k", "v"} [L, B, KVH, Smax, hd]
  decode_step(cfg, params, tokens [B], cache, lengths [B])
                                      -> (logits [B, V], cache')

``forward_train`` runs under autograd: the loss
(``common.cross_entropy``) and its gradient are taken by
``repro_torch.train.steps``, and with ``cfg.remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``), as the JAX
stack wraps each layer in ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.models import common


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer sliding window sizes (0 = full attention)."""
    if cfg.window <= 0:
        return np.zeros((cfg.n_layers,), np.int32)
    w = np.full((cfg.n_layers,), cfg.window, np.int32)
    if cfg.global_every > 0:
        w[cfg.global_every - 1:: cfg.global_every] = 0  # every k-th global
    return w


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.moe is not None or cfg.vlm is not None or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder family is ported "
            "(MoE / VLM / encoder-only: see ROADMAP.md)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init(cfg: ArchConfig, gen: torch.Generator) -> Dict:
    """Seeded random parameters on ``gen.device`` (fp32 ``param_dtype``),
    in the JAX package's layout.  The values follow ``gen``, not the JAX
    PRNG: to carry JAX weights over use ``registry.params_from_numpy``."""
    _dense_only(cfg)
    dev = gen.device
    params = {"tok": common.init_embed(cfg, gen)}
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": common.init_norm(cfg, cfg.d_model, dev),
            "attn": common.init_attention(cfg, gen),
            "ln2": common.init_norm(cfg, cfg.d_model, dev),
            "mlp": common.init_mlp(cfg, gen),
        })
    params["layers"] = _stack(layers)
    params["ln_f"] = common.init_norm(cfg, cfg.d_model, dev)
    return params


def layer_params(params: Dict, l: int) -> Dict:
    """Layer ``l``'s parameters (views into the stacked [L, ...] tensors)."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[l]
    return pick(params["layers"])


def layer_list(cfg: ArchConfig, params: Dict) -> List[Dict]:
    """Every layer's parameters, split off the stacked [L, ...] tensors by
    one ``unbind`` each, whose gradient is one stack (a per-layer index
    would scatter into a zero [L, ...] tensor for every layer)."""
    def split(t):
        if isinstance(t, dict):
            parts = {k: split(v) for k, v in t.items()}
            return [{k: v[l] for k, v in parts.items()}
                    for l in range(cfg.n_layers)]
        return torch.unbind(t, 0)
    return split(params["layers"])


def _device(params: Dict) -> torch.device:
    return params["tok"]["embed"].device


def _tokens(tokens, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                           else tokens, device=dev).long()


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------

def _layer_fwd(cfg, lp, x, positions, window: int, causal: bool,
               return_kv: bool):
    h = common.apply_norm(cfg, lp["ln1"], x)
    a = common.attention_fwd(cfg, lp["attn"], h, positions, window=window,
                             causal=causal, return_kv=return_kv)
    a, kv = (a[0], a[1:]) if return_kv else (a, None)
    x = x + a
    h = common.apply_norm(cfg, lp["ln2"], x)
    return x + common.mlp_fwd(cfg, lp["mlp"], h), kv


def _train_layer(cfg, lp, x, positions, window: int):
    return _layer_fwd(cfg, lp, x, positions, window, True, False)[0]


def forward_train(cfg: ArchConfig, params: Dict, tokens
                  ) -> Tuple[torch.Tensor, Dict]:
    """The forward of the training step: logits [B, S, V] and ``aux``
    (the dense family's ``aux_loss`` is 0), differentiable in ``params``.
    With ``cfg.remat`` and grad mode on, each layer keeps only its input
    and reruns in the backward (its window passed as a Python int)."""
    _dense_only(cfg)
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    x = common.embed_tokens(cfg, params["tok"], tokens)
    positions = torch.arange(tokens.shape[1], device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp, window in zip(layer_list(cfg, params),
                          layer_windows(cfg).tolist()):
        if remat:
            # no randomness inside a layer: no RNG state to replay
            x = checkpoint(_train_layer, cfg, lp, x, positions, int(window),
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _train_layer(cfg, lp, x, positions, int(window))
    x = common.apply_norm(cfg, params["ln_f"], x)
    logits = common.unembed(cfg, params["tok"], x)
    return logits, {"aux_loss": torch.zeros((), device=dev)}


def prefill(cfg: ArchConfig, params: Dict, tokens, Smax: int,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """Forward over a prompt batch, capturing the KV cache: (logits
    [B, S, V], cache with k/v valid on [:S] and zero after)."""
    _dense_only(cfg)
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    x = common.embed_tokens(cfg, params["tok"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=dev)
    cache = init_cache(cfg, B, Smax, cache_dtype, device=dev)
    for l, window in enumerate(layer_windows(cfg).tolist()):
        x, (k, v) = _layer_fwd(cfg, layer_params(params, l), x, positions,
                               window, True, True)
        cache["k"][l, :, :, :S] = k.to(cache_dtype)
        cache["v"][l, :, :, :S] = v.to(cache_dtype)
    x = common.apply_norm(cfg, params["ln_f"], x)
    return common.unembed(cfg, params["tok"], x), cache


def init_cache(cfg: ArchConfig, B: int, Smax: int, dtype=torch.bfloat16,
               device=None) -> Dict:
    """Zero KV cache [L, B, KVH, Smax, hd] on ``device`` (default cuda)."""
    from repro_torch.core.store import resolve_device

    shape = (cfg.n_layers, B, cfg.n_kv_heads, Smax, cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(cfg: ArchConfig, params: Dict, tokens, cache: Dict,
                lengths) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence: (logits [B, V], the new cache).  The input
    cache is not written into."""
    _dense_only(cfg)
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    lengths = torch.as_tensor(np.asarray(lengths) if not torch.is_tensor(
        lengths) else lengths, device=dev).int()
    x = common.embed_tokens(cfg, params["tok"], tokens[:, None])  # [B,1,D]
    ks, vs = [], []
    for l, window in enumerate(layer_windows(cfg).tolist()):
        lp = layer_params(params, l)
        h = common.apply_norm(cfg, lp["ln1"], x)
        a, ck, cv = common.attention_decode(
            cfg, lp["attn"], h, cache["k"][l], cache["v"][l], lengths,
            window=window)
        x = x + a
        h = common.apply_norm(cfg, lp["ln2"], x)
        x = x + common.mlp_fwd(cfg, lp["mlp"], h)
        ks.append(ck)
        vs.append(cv)
    x = common.apply_norm(cfg, params["ln_f"], x)
    logits = common.unembed(cfg, params["tok"], x)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
