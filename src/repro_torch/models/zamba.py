"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention
block.

A port of the JAX package's ``repro.models.zamba``.  Every
``hybrid_attn_every``-th layer applies one globally shared attention +
MLP block (the same parameters at every occurrence), the Zamba2 way of
amortising attention parameters over a cheap SSM backbone.  (The
released model alternates two shared blocks; this, like the JAX
package, uses one.)

The backbone's parameters are stacked [L, ...]; ``lax.cond`` on the
layer index becomes a Python ``if``.  The shared block calls
``common.attention_fwd`` / ``attention_decode``, which take the flash and
decode kernels on a CUDA tensor.  The decode cache holds each layer's
Mamba2 state and one KV cache per shared-block occurrence.

API:
  init(cfg, gen)                     -> params
  forward_train(cfg, params, tokens) -> (logits [B, S, V], aux)
  init_cache(cfg, B, Smax, ...)      -> {"mamba": {"h", "conv"} [L, ...],
                                         "attn_k", "attn_v"
                                         [n_occ, B, KVH, Smax, hd]}
  decode_step(cfg, params, tokens [B], cache, lengths [B])
                                     -> (logits [B, V], cache')
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.distributed.ctx import shard_act
from repro_torch.models import common, mamba2
from repro_torch.models.transformer import _device, _tensor, _tokens


def _init_shared(cfg: ArchConfig, gen: torch.Generator, dev) -> Dict:
    return {
        "ln1": common.init_norm(cfg, cfg.d_model, dev),
        "attn": common.init_attention(cfg, gen, dev),
        "ln2": common.init_norm(cfg, cfg.d_model, dev),
        "mlp": common.init_mlp(cfg, gen, device=dev),
    }


def init(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """Seeded parameters on ``device`` (default ``gen.device``) in the
    JAX package's layout (the values follow ``gen``, not the JAX PRNG)."""
    dev = common.init_device(gen, device)
    return {
        "tok": common.init_embed(cfg, gen, dev),
        "mamba": common.stacked(cfg.n_layers,
                                lambda: mamba2.init_block(cfg, gen, dev)),
        "shared": _init_shared(cfg, gen, dev),
        "ln_f": common.init_norm(cfg, cfg.d_model, dev),
    }


def _shared_fwd(cfg: ArchConfig, sp: Dict, x, positions):
    h = common.apply_norm(cfg, sp["ln1"], x)
    x = x + common.attention_fwd(cfg, sp["attn"], h, positions, window=0,
                                 causal=True)
    h = common.apply_norm(cfg, sp["ln2"], x)
    return x + common.mlp_fwd(cfg, sp["mlp"], h)


def _layer(cfg: ArchConfig, lp: Dict, sp: Dict, x, positions,
           shared: bool):
    x = mamba2.block_fwd(cfg, lp, x)
    return _shared_fwd(cfg, sp, x, positions) if shared else x


def forward_train(cfg: ArchConfig, params: Dict, tokens, **_
                  ) -> Tuple[torch.Tensor, Dict]:
    """Logits [B, S, V] and ``aux`` (a zero ``aux_loss``), differentiable
    in ``params``.  With ``cfg.remat`` and grad mode on, each layer (its
    shared block included) keeps only its input and reruns in the
    backward, as the JAX scan body is checkpointed."""
    dev = _device(params)
    x = shard_act(common.embed_tokens(cfg, params["tok"],
                                      _tokens(tokens, dev)), "residual")
    positions = torch.arange(x.shape[1], device=dev)
    k = cfg.hybrid_attn_every
    remat = cfg.remat and torch.is_grad_enabled()
    for idx, lp in enumerate(common.unstack(params["mamba"], cfg.n_layers)):
        shared = (idx + 1) % k == 0
        if remat:
            x = checkpoint(_layer, cfg, lp, params["shared"], x, positions,
                           shared, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(cfg, lp, params["shared"], x, positions, shared)
        x = shard_act(x, "residual")
    x = common.apply_norm(cfg, params["ln_f"], x)
    logits = common.unembed(cfg, params["tok"], x)
    return logits, {"aux_loss": torch.zeros((), device=dev)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, B: int, Smax: int, dtype=torch.bfloat16,
               device=None) -> Dict:
    """Zero states on ``device`` (default cuda): each layer's fp32 Mamba2
    state and a [n_occ, B, KVH, Smax, hd] KV cache in ``dtype``."""
    dev = common.cache_device(device)
    n_occ = cfg.n_layers // cfg.hybrid_attn_every
    st = mamba2.init_state(cfg, B, dev)
    shape = (n_occ, B, cfg.n_kv_heads, Smax, cfg.resolved_head_dim)
    return {
        "mamba": {k: v.new_zeros((cfg.n_layers,) + tuple(v.shape))
                  for k, v in st.items()},
        "attn_k": torch.zeros(shape, dtype=dtype, device=dev),
        "attn_v": torch.zeros(shape, dtype=dtype, device=dev),
    }


def decode_step(cfg: ArchConfig, params: Dict, tokens, cache: Dict,
                lengths) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence: (logits [B, V], the new cache).  The input
    cache is not written into."""
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    lengths = _tensor(lengths, dev).int()
    x = common.embed_tokens(cfg, params["tok"], tokens[:, None])
    k = cfg.hybrid_attn_every
    sp = params["shared"]
    hs, convs, ks, vs = [], [], [], []
    for i in range(cfg.n_layers):
        x, st = mamba2.block_decode(cfg, common.row(params["mamba"], i), x,
                                    common.row(cache["mamba"], i))
        hs.append(st["h"])
        convs.append(st["conv"])
        if (i + 1) % k == 0:
            occ = (i + 1) // k - 1
            h = common.apply_norm(cfg, sp["ln1"], x)
            a, nk, nv = common.attention_decode(
                cfg, sp["attn"], h, cache["attn_k"][occ],
                cache["attn_v"][occ], lengths, window=0)
            x = x + a
            ks.append(nk)
            vs.append(nv)
            h = common.apply_norm(cfg, sp["ln2"], x)
            x = x + common.mlp_fwd(cfg, sp["mlp"], h)
    x = common.apply_norm(cfg, params["ln_f"], x)
    logits = common.unembed(cfg, params["tok"], x)[:, 0]
    return logits, {
        "mamba": {"h": torch.stack(hs), "conv": torch.stack(convs)},
        "attn_k": torch.stack(ks) if ks else cache["attn_k"],
        "attn_v": torch.stack(vs) if vs else cache["attn_v"],
    }
