"""Transformer stack (dense / MoE / VLM / audio-encoder families).

A port of the JAX package's ``repro.models.transformer``.  Layers are
*stacked* as there: every per-layer parameter carries a leading [L]
axis.  ``lax.scan`` over layers becomes a Python loop, and each layer's
attention window (``layer_windows``) is a plain ``int``, as the flash
kernel takes it.  A MoE config swaps each layer's MLP for
``moe.moe_fwd``; a VLM prepends the projected patch features to the
token embeddings; the encoder-only (audio) model takes frame embeddings
through ``in_norm`` and attends without the causal mask.

API:
  init(cfg, gen)                      -> params
  forward_train(cfg, params, tokens, patches=None, embeds=None)
                                      -> (logits [B, S, V], aux)
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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.distributed.ctx import shard_act
from repro_torch.models import common, moe


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer sliding window sizes (0 = full attention)."""
    if cfg.window <= 0:
        return np.zeros((cfg.n_layers,), np.int32)
    w = np.full((cfg.n_layers,), cfg.window, np.int32)
    if cfg.global_every > 0:
        w[cfg.global_every - 1:: cfg.global_every] = 0  # every k-th global
    return w


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, gen: torch.Generator, dev) -> Dict:
    p = {
        "ln1": common.init_norm(cfg, cfg.d_model, dev),
        "attn": common.init_attention(cfg, gen, dev),
        "ln2": common.init_norm(cfg, cfg.d_model, dev),
    }
    if cfg.moe is not None:
        p["moe"] = moe.init_moe(cfg, gen, dev)
    else:
        p["mlp"] = common.init_mlp(cfg, gen, device=dev)
    return p


def init(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """Seeded random parameters on ``device`` (default ``gen.device``;
    fp32 ``param_dtype``), in the JAX package's layout.  The values follow
    ``gen``, not the JAX PRNG: to carry JAX weights over use
    ``registry.params_from_numpy``.

    Each stacked [L, ...] tensor is allocated once and each layer, drawn
    in turn, is copied into its row, so the peak holds one layer beyond
    the parameters (deepseek-moe-16b's are 66.7 GB)."""
    dev = common.init_device(gen, device)
    params = {"tok": common.init_embed(cfg, gen, dev)}
    params["layers"] = common.stacked(cfg.n_layers,
                                      lambda: _init_layer(cfg, gen, dev))
    params["ln_f"] = common.init_norm(cfg, cfg.d_model, dev)
    if cfg.vlm is not None:
        params["projector"] = {
            "w1": common._normal(gen, (cfg.vlm.patch_dim, cfg.d_model), cfg,
                                 0.02, dev),
            "w2": common._normal(gen, (cfg.d_model, cfg.d_model), cfg, 0.02,
                                 dev),
        }
    if cfg.encoder_only:
        # audio frontend stub: frame features arrive at d_model; a learned
        # input norm stands in for the conv feature projector
        params["in_norm"] = common.init_norm(cfg, cfg.d_model, dev)
    return params


def layer_params(params: Dict, l: int) -> Dict:
    """Layer ``l``'s parameters (views into the stacked [L, ...] tensors)."""
    return common.row(params["layers"], l)


def layer_list(cfg: ArchConfig, params: Dict) -> List[Dict]:
    """Every layer's parameters (``common.unstack`` of the stacked
    [L, ...] tensors)."""
    return common.unstack(params["layers"], cfg.n_layers)


def _device(params: Dict) -> torch.device:
    return params["tok"]["embed"].device


def _tensor(t, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t,
                           device=dev)


def _tokens(tokens, dev) -> torch.Tensor:
    return _tensor(tokens, dev).long()


# ---------------------------------------------------------------------------
# forward (train / prefill) and decode
# ---------------------------------------------------------------------------

def _ffn(cfg, lp, h):
    """The layer's MLP, or its MoE: (y, aux dict or None)."""
    if cfg.moe is not None:
        return moe.moe_fwd(cfg, lp["moe"], h)
    return common.mlp_fwd(cfg, lp["mlp"], h), None


def _layer_fwd(cfg, lp, x, positions, window: int, causal: bool,
               return_kv: bool):
    h = common.apply_norm(cfg, lp["ln1"], x)
    a = common.attention_fwd(cfg, lp["attn"], h, positions, window=window,
                             causal=causal, return_kv=return_kv)
    a, kv = (a[0], a[1:]) if return_kv else (a, None)
    x = shard_act(x + a, "residual")
    y, aux = _ffn(cfg, lp, common.apply_norm(cfg, lp["ln2"], x))
    return shard_act(x + y, "residual"), kv, aux


MOE_AUX = ("moe_balance", "moe_z", "moe_dropped")


def _train_layer(cfg, lp, x, positions, window: int, causal: bool):
    """(x, the layer's MoE aux (balance, z, dropped) or None): tensors
    only, so they come out of ``checkpoint`` with ``x``."""
    x, _, aux = _layer_fwd(cfg, lp, x, positions, window, causal, False)
    return x, None if aux is None else tuple(aux[k] for k in MOE_AUX)


def forward_train(cfg: ArchConfig, params: Dict, tokens=None, patches=None,
                  embeds=None) -> Tuple[torch.Tensor, Dict]:
    """The forward of the training step: logits [B, S, V] and ``aux``,
    differentiable in ``params``.  ``tokens`` [B, S] for the decoders; a
    VLM also takes ``patches`` [B, NP, patch_dim], projected and put
    before the text (logits over NP + S rows); the encoder-only model
    takes ``embeds`` [B, S, d_model] instead of tokens and no causal
    mask.  ``aux["aux_loss"]`` is the sum over layers of each MoE layer's
    balance + z + dropped share (0 for the other families), and a MoE
    model's aux also holds each of the three's mean over layers.  With
    ``cfg.remat`` and grad mode on, each layer keeps only its input and
    reruns in the backward (its window passed as a Python int)."""
    dev = _device(params)
    cdt = common.dtype_of(cfg.compute_dtype)
    causal = not cfg.encoder_only
    if cfg.encoder_only:
        x = common.apply_norm(cfg, params["in_norm"],
                              _tensor(embeds, dev).to(cdt))
    else:
        x = common.embed_tokens(cfg, params["tok"], _tokens(tokens, dev))
        if cfg.vlm is not None:
            proj = params["projector"]
            pe = _tensor(patches, dev).to(cdt) @ proj["w1"].to(cdt)
            pe = F.gelu(pe, approximate="tanh") @ proj["w2"].to(cdt)
            x = torch.cat([pe, x], dim=1)
    x = shard_act(x, "residual")
    positions = torch.arange(x.shape[1], device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for lp, window in zip(layer_list(cfg, params),
                          layer_windows(cfg).tolist()):
        if remat:
            # no randomness inside a layer: no RNG state to replay
            x, aux = checkpoint(_train_layer, cfg, lp, x, positions,
                                int(window), causal, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _train_layer(cfg, lp, x, positions, int(window), causal)
        auxes.append(aux)
    x = common.apply_norm(cfg, params["ln_f"], x)
    logits = common.unembed(cfg, params["tok"], x)
    if cfg.moe is None:
        return logits, {"aux_loss": torch.zeros((), device=dev)}
    per_layer = torch.stack([torch.stack(a) for a in auxes])     # [L, 3]
    out = {k: per_layer[:, i].mean() for i, k in enumerate(MOE_AUX)}
    out["aux_loss"] = per_layer.sum(1).sum()
    return logits, out


def prefill(cfg: ArchConfig, params: Dict, tokens, Smax: int,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """Forward over a prompt batch, capturing the KV cache: (logits
    [B, S, V], cache with k/v valid on [:S] and zero after)."""
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    x = shard_act(common.embed_tokens(cfg, params["tok"], tokens),
                  "residual")
    B, S = tokens.shape
    positions = torch.arange(S, device=dev)
    cache = init_cache(cfg, B, Smax, cache_dtype, device=dev)
    for l, window in enumerate(layer_windows(cfg).tolist()):
        x, (k, v), _ = _layer_fwd(cfg, layer_params(params, l), x,
                                  positions, window, True, True)
        cache["k"][l, :, :, :S] = k.to(cache_dtype)
        cache["v"][l, :, :, :S] = v.to(cache_dtype)
    x = common.apply_norm(cfg, params["ln_f"], x)
    return common.unembed(cfg, params["tok"], x), cache


def init_cache(cfg: ArchConfig, B: int, Smax: int, dtype=torch.bfloat16,
               device=None) -> Dict:
    """Zero KV cache [L, B, KVH, Smax, hd] on ``device`` (default cuda;
    ``meta`` for the dry run)."""
    shape = (cfg.n_layers, B, cfg.n_kv_heads, Smax, cfg.resolved_head_dim)
    dev = common.cache_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(cfg: ArchConfig, params: Dict, tokens, cache: Dict,
                lengths) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence: (logits [B, V], the new cache).  The input
    cache is not written into."""
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    lengths = _tensor(lengths, dev).int()
    x = common.embed_tokens(cfg, params["tok"], tokens[:, None])  # [B,1,D]
    ks, vs = [], []
    for l, window in enumerate(layer_windows(cfg).tolist()):
        lp = layer_params(params, l)
        h = common.apply_norm(cfg, lp["ln1"], x)
        a, ck, cv = common.attention_decode(
            cfg, lp["attn"], h, cache["k"][l], cache["v"][l], lengths,
            window=window)
        x = x + a
        x = x + _ffn(cfg, lp, common.apply_norm(cfg, lp["ln2"], x))[0]
        ks.append(ck)
        vs.append(cv)
    x = common.apply_norm(cfg, params["ln_f"], x)
    logits = common.unembed(cfg, params["tok"], x)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
