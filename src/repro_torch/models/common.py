"""Shared model blocks: norms, RoPE, attention, MLPs, embeddings, loss.

A port of the JAX package's ``repro.models.common``: pure functions over
parameter dicts of tensors, with the JAX package's names and layouts
(``wq`` [d, H, hd], q [B, H, S, hd], KV cache [B, KVH, Smax, hd]).
Parameters are kept in ``param_dtype`` and cast to ``compute_dtype`` at
every use, as in JAX.  Attention goes through the port's kernels: the
hand-written CUDA kernels on a CUDA tensor, their plain twins on the CPU.
Initializers take an explicit ``torch.Generator`` and draw on its device
unless given another ``device`` (``meta``: shapes only, nothing
allocated; the dry run's parameters).  Everything here is
differentiable: attention under autograd takes the backward kernel on
the card (``kernels.flash_attention.ops``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.distributed.ctx import shard_act
from repro_torch.kernels.decode_attention.ops import decode
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.optim.adamw import tree_map

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def init_device(gen: torch.Generator, device=None) -> torch.device:
    """Where an initializer draws: ``device``, else ``gen.device``.  A
    generator cannot live on ``meta``; a CPU one draws meta tensors."""
    return gen.device if device is None else torch.device(device)


def cache_device(device=None) -> torch.device:
    """Where a decode cache lives: ``meta`` as asked (the dry run), else
    ``resolve_device``'s rule (``cuda`` unless the caller asks for the
    CPU)."""
    from repro_torch.core.store import resolve_device

    if device is not None and torch.device(device).type == "meta":
        return torch.device(device)
    return resolve_device(device)


def _normal(gen: torch.Generator, shape, cfg: ArchConfig, scale: float,
            device=None):
    return torch.randn(shape, generator=gen,
                       device=init_device(gen, device),
                       dtype=dtype_of(cfg.param_dtype)) * scale


def stacked(n: int, draw: Callable[[], Dict]) -> Dict:
    """``n`` calls of ``draw`` stacked on a leading [n] axis, as the JAX
    package's ``vmap``-ed inits lay layers out.  Each stacked tensor is
    allocated once and each draw, made in turn, is copied into its row,
    so the peak holds one draw beyond the result."""
    out = None
    for l in range(n):
        one = draw()
        if out is None:
            out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), one)
        tree_map(lambda dst, src: dst[l].copy_(src), out, one)
        del one
    return out


def unstack(tree: Dict, n: int) -> List[Dict]:
    """The ``n`` rows of a stacked [n, ...] tree, split by one ``unbind``
    a tensor, whose gradient is one stack (a per-row index would scatter
    into a zero [n, ...] tensor for every row)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[l] for k, v in parts.items()} for l in range(n)]
    return list(torch.unbind(tree, 0))


def row(tree, i: int):
    """Row ``i`` of every tensor of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: row(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(row(v, i) for v in tree)
    return tree[i]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, d: int, device) -> Dict:
    if cfg.norm == "layernorm_np":      # olmo: non-parametric LayerNorm
        return {}
    return {"scale": torch.ones(d, dtype=dtype_of(cfg.param_dtype),
                                device=device)}


def apply_norm(cfg: ArchConfig, p, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm == "layernorm_np":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
    else:
        out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        out = out * p["scale"].float()
    return out.to(x.dtype)


def rms_headnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """qwen3-style per-head qk-norm: x [..., hd], scale [hd]."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x [..., S, hd] (hd even), positions broadcastable to [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (prefill through the flash kernel, decode through the decode
# kernel)
# ---------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, gen: torch.Generator,
                   device=None) -> Dict:
    d, H, KVH, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    dev = init_device(gen, device)
    s = 0.02
    p = {
        "wq": _normal(gen, (d, H, hd), cfg, s, dev),
        "wk": _normal(gen, (d, KVH, hd), cfg, s, dev),
        "wv": _normal(gen, (d, KVH, hd), cfg, s, dev),
        "wo": _normal(gen, (H, hd, d), cfg,
                      s / max(1, cfg.n_layers) ** 0.5, dev),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype_of(cfg.param_dtype),
                                 device=dev)
        p["k_norm"] = torch.ones(hd, dtype=dtype_of(cfg.param_dtype),
                                 device=dev)
    return p


def _qkv(cfg: ArchConfig, p: Dict, xc: torch.Tensor):
    cdt = xc.dtype
    q = torch.einsum("bsd,dhk->bhsk", xc, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bhsk", xc, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bhsk", xc, p["wv"].to(cdt))
    return q, k, v


def attention_fwd(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int,
                  causal: bool = True, return_kv: bool = False):
    """x [B, S, D] -> [B, S, D]; with ``return_kv`` also the post-RoPE
    k, v [B, KVH, S, hd] (the KV-cache layout).  ``window`` is a static
    int (0 = full attention)."""
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    q, k, v = _qkv(cfg, p, xc)
    if cfg.qk_norm:
        q = rms_headnorm(p["q_norm"], q)
        k = rms_headnorm(p["k_norm"], k)
    pos_b = (positions[None, None, :] if positions.dim() == 1
             else positions[:, None, :])
    q = rope(q, pos_b, cfg.rope_theta)
    k = rope(k, pos_b, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=int(window)).to(cdt)
    out = torch.einsum("bhqk,hkd->bqd", o, p["wo"].to(cdt)).to(x.dtype)
    if return_kv:
        return out, k, v
    return out


def attention_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, 1, D] (the current token), cache [B, KVH, Smax, hd], lengths
    [B] (valid cache rows before this token) -> (out [B, 1, D], cache_k,
    cache_v) with this token's k/v written at row ``lengths[b]``.

    A row at ``lengths[b] == Smax`` is past the cache: its write is
    dropped (as the JAX scatter drops it) and the attention sees the whole
    cache.  With ``window`` > 0 (a static int) the token attends to rows
    ``kpos > lengths[b] - window`` only, the JAX rule.  The inputs are not
    written into.
    """
    cdt = dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    xc = x.to(cdt)
    q, k, v = (t[:, :, 0] for t in _qkv(cfg, p, xc))      # [B, H|KVH, hd]
    if cfg.qk_norm:
        q = rms_headnorm(p["q_norm"], q)
        k = rms_headnorm(p["k_norm"], k)
    lengths = lengths.to(x.device)
    pos = lengths.float()
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)

    # append (k, v) at row lengths[b]; a row past the cache writes nothing
    Smax = cache_k.shape[2]
    at = (torch.arange(Smax, device=x.device)[None, :]
          == lengths[:, None])[:, None, :, None]          # [B, 1, Smax, 1]
    cache_k = torch.where(at, k[:, :, None, :].to(cache_k.dtype), cache_k)
    cache_v = torch.where(at, v[:, :, None, :].to(cache_v.dtype), cache_v)
    cache_k = shard_act(cache_k, "kv4")
    cache_v = shard_act(cache_v, "kv4")

    # the kernel attends to rows < its length: this token's row included
    kv_len = (lengths + 1).clamp_max(Smax).int()
    # and, in a window, to rows >= its start, from the unclamped length:
    # at lengths == Smax (the write dropped) that keeps window - 1 rows,
    # as the JAX mask does
    starts = ((lengths + 1 - int(window)).clamp_min(0).int()
              if int(window) > 0 else None)
    o = decode(q.to(cache_k.dtype), cache_k, cache_v, kv_len, starts)
    o = o.reshape(B, H, hd).to(cdt)
    out = torch.einsum("bhk,hkd->bd", o, p["wo"].to(cdt))[:, None, :]
    return out.to(x.dtype), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU) and embeddings
# ---------------------------------------------------------------------------

def init_mlp(cfg: ArchConfig, gen: torch.Generator,
             d_ff: Optional[int] = None, device=None) -> Dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dev = init_device(gen, device)
    s = 0.02
    return {
        "w1": _normal(gen, (d, f), cfg, s, dev),
        "w3": _normal(gen, (d, f), cfg, s, dev),
        "w2": _normal(gen, (f, d), cfg, s / max(1, cfg.n_layers) ** 0.5,
                      dev),
    }


def mlp_fwd(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    a = xc @ p["w1"].to(cdt)
    a = F.silu(a) if cfg.act == "silu" else F.gelu(a, approximate="tanh")
    h = a * (xc @ p["w3"].to(cdt))
    return (h @ p["w2"].to(cdt)).to(x.dtype)


def init_embed(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    dev = init_device(gen, device)
    p = {"embed": _normal(gen, (cfg.vocab, cfg.d_model), cfg, 0.02, dev)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab), cfg, 0.02,
                               dev)
    return p


def embed_tokens(cfg: ArchConfig, p: Dict, tokens: torch.Tensor):
    # F.embedding, not indexing: its gradient on the card sums each row's
    # contributions in a fixed order (indexing's scatter may not)
    x = F.embedding(tokens, p["embed"]).to(dtype_of(cfg.compute_dtype))
    if cfg.family == "dense" and cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)  # gemma embedding scaling
    return x


def unembed(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    w = p["embed"].to(cdt).T if cfg.tie_embeddings \
        else p["unembed"].to(cdt)
    return shard_act(x.to(cdt) @ w, "logits")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, z_coef: float = 1e-4):
    """Token CE with z-loss, in fp32 whatever the logits' dtype: logits
    [B, S, V], labels and mask [B, S] -> (loss, {"nll", "acc"})."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    z = z_coef * (lse ** 2)
    m = mask.float()
    denom = m.sum().clamp_min(1.0)
    loss = ((nll + z) * m).sum() / denom
    acc = ((lf.argmax(-1) == labels) & mask.bool()).sum() / denom
    return loss, {"nll": (nll * m).sum() / denom, "acc": acc}
