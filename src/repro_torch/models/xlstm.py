"""xLSTM: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, recurrent) blocks, grouped m:1 (the paper's xLSTM[7:1]).

A port of the JAX package's ``repro.models.xlstm``.  The mLSTM update
C_t = f_t C_{t-1} + i_t v_t k_t^T,  n_t = f_t n_{t-1} + i_t k_t,
h_t = (C_t q_t) / max(|n_t . q_t|, 1) has the SSD algebra, so training
runs ``mamba2.ssd_chunked`` (decay f, u = i·v, B = k, C = q), with the
normaliser as one more P column of the same pass.  Gates are sigmoids,
as in the JAX package.

The sLSTM recurrence is nonlinear (h feeds back through R) and runs as
a Python loop over time steps.  The config's ``d_ff`` is 0: each block
carries its own up and down projections.  Neither block has a Pallas
kernel in the JAX package; both are PyTorch code here.

API:
  init(cfg, gen)                     -> params {"tok", "mlstm" [G m, ...],
                                        "slstm" [G, ...], "ln_f"}
  forward_train(cfg, params, tokens) -> (logits [B, S, V], aux)
  init_cache(cfg, B, Smax, ...)      -> {"mlstm": {"C", "n", "conv"},
                                         "slstm": (c, n, h)}
  decode_step(cfg, params, tokens [B], cache, lengths [B])
                                     -> (logits [B, V], cache')
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig
from repro_torch.distributed.ctx import shard_act
from repro_torch.models import common
from repro_torch.models.mamba2 import ssd_chunked, ssd_recurrent_step
from repro_torch.models.transformer import _device, _tokens

MLSTM_CHUNK = 256      # the mLSTM's ssd_chunked chunk, as in the JAX block


def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(inner width, heads, head width) of the mLSTM."""
    x = cfg.xlstm
    di = int(x.proj_factor * cfg.d_model)
    nh = max(1, di // x.head_dim)
    return di, nh, di // nh


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """The JAX package's keys and shapes; ``w_if`` and ``b_if`` (forget
    bias 3: long memory at init) are fp32 whatever ``param_dtype`` is."""
    x = cfg.xlstm
    d = cfg.d_model
    di, nh, hd = _dims(cfg)
    dev = common.init_device(gen, device)
    s = 0.02
    b_if = torch.zeros((nh, 2), dtype=torch.float32, device=dev)
    b_if[:, 1] = 3.0
    return {
        "ln": common.init_norm(cfg, d, dev),
        "up": common._normal(gen, (d, 2 * di), cfg, s, dev),
        "conv_w": common._normal(gen, (x.d_conv, di), cfg, 0.2, dev),
        "conv_b": torch.zeros(di, dtype=common.dtype_of(cfg.param_dtype),
                              device=dev),
        "wq": common._normal(gen, (di, nh, hd), cfg, s, dev),
        "wk": common._normal(gen, (di, nh, hd), cfg, s, dev),
        "wv": common._normal(gen, (di, nh, hd), cfg, s, dev),
        "w_if": torch.randn((di, nh, 2), generator=gen, device=dev,
                            dtype=torch.float32) * s,
        "b_if": b_if,
        "out_norm": common.init_norm(cfg, di, dev),
        "down": common._normal(gen, (di, d), cfg,
                               s / max(1, cfg.n_layers) ** 0.5, dev),
    }


def _conv_causal(xbc, w, b, S: int):
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i: i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b)


def mlstm_fwd(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] (training / prefill, chunked).  S over
    the chunk of 256 must be a multiple of it."""
    cdt = common.dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    di, nh, hd = _dims(cfg)
    h = common.apply_norm(cfg, p["ln"], x).to(cdt)
    up = h @ p["up"].to(cdt)
    main, gate = up[..., :di], up[..., di:]
    c = _conv_causal(main, p["conv_w"].to(cdt), p["conv_b"].to(cdt), S)
    q = torch.einsum("bsd,dhk->bshk", c, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", c, p["wk"].to(cdt)) / (hd ** 0.5)
    v = torch.einsum("bsd,dhk->bshk", main, p["wv"].to(cdt))
    gif = torch.einsum("bsd,dhg->bshg", c.float(), p["w_if"]) + p["b_if"]
    ig = torch.sigmoid(gif[..., 0])                             # [B,S,nh]
    fg = torch.sigmoid(gif[..., 1])

    u = v * ig[..., None].to(v.dtype)
    # the normaliser rides as one more P column: u' = [u | i]
    u_aug = torch.cat([u, ig[..., None].to(u.dtype)], -1)
    y_aug, _ = ssd_chunked(u_aug, fg, k, q, MLSTM_CHUNK)
    y, yn = y_aug[..., :hd], y_aug[..., hd:]
    y = y / torch.clamp_min(torch.abs(yn), 1.0)
    y = y.reshape(B, S, di).to(cdt) * F.silu(gate)
    y = common.apply_norm(cfg, p["out_norm"], y)
    return x + (y @ p["down"].to(cdt)).to(x.dtype)


def init_mlstm_state(cfg: ArchConfig, B: int, device) -> Dict:
    di, nh, hd = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, nh, hd, hd), **f32),
            "n": torch.zeros((B, nh, 1, hd), **f32),
            "conv": torch.zeros((B, cfg.xlstm.d_conv - 1, di), **f32)}


def mlstm_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor, st: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """x [B, 1, D], one token -> (y [B, 1, D], the new state); the conv,
    the projections and the recurrence in fp32."""
    cdt = common.dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    di, nh, hd = _dims(cfg)
    h = common.apply_norm(cfg, p["ln"], x).to(cdt)
    up = (h @ p["up"].to(cdt))[:, 0]
    main, gate = up[..., :di], up[..., di:]
    hist = torch.cat([st["conv"], main[:, None, :].float()], 1)
    c = torch.einsum("bkc,kc->bc", hist, p["conv_w"].float())
    c = F.silu(c + p["conv_b"].float())
    q = torch.einsum("bd,dhk->bhk", c, p["wq"].float())
    k = torch.einsum("bd,dhk->bhk", c, p["wk"].float()) / (hd ** 0.5)
    v = torch.einsum("bd,dhk->bhk", main.float(), p["wv"].float())
    gif = torch.einsum("bd,dhg->bhg", c, p["w_if"]) + p["b_if"]
    ig = torch.sigmoid(gif[..., 0])
    fg = torch.sigmoid(gif[..., 1])
    C, yC = ssd_recurrent_step(st["C"], v * ig[..., None], fg, k, q)
    n, yn = ssd_recurrent_step(st["n"], ig[..., None], fg, k, q)
    y = yC / torch.clamp_min(torch.abs(yn), 1.0)
    y = y.reshape(B, di).to(cdt) * F.silu(gate)
    y = common.apply_norm(cfg, p["out_norm"], y)
    out = x + (y @ p["down"].to(cdt))[:, None, :].to(x.dtype)
    return out, {"C": C, "n": n, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def init_slstm(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """``W`` [d, nh, 4, hd], ``R`` [nh, hd, 4, hd] and ``b`` (forget bias
    3) are fp32 whatever ``param_dtype`` is."""
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dev = common.init_device(gen, device)
    s = 0.02
    f32 = dict(generator=gen, device=dev, dtype=torch.float32)
    b = torch.zeros((nh, 4, hd), dtype=torch.float32, device=dev)
    b[:, 1] = 3.0
    return {
        "ln": common.init_norm(cfg, d, dev),
        "W": torch.randn((d, nh, 4, hd), **f32) * s,
        "R": torch.randn((nh, hd, 4, hd), **f32) * s,
        "b": b,
        "out": common._normal(gen, (d, d), cfg,
                              s / max(1, cfg.n_layers) ** 0.5, dev),
    }


def _gates(g, c, n):
    """The sLSTM's gate update from pre-activations g [B, nh, 4, hd]."""
    i = torch.sigmoid(g[:, :, 0])
    f = torch.sigmoid(g[:, :, 1])
    z = torch.tanh(g[:, :, 2])
    o = torch.sigmoid(g[:, :, 3])
    c = f * c + i * z
    n = f * n + i
    return c, n, o * c / torch.clamp_min(n, 1.0)


def _slstm_cell(p: Dict, x_t: torch.Tensor, state):
    """x_t [B, d]; state (c, n, h) each [B, nh, hd]."""
    c, n, h = state
    g = torch.einsum("bd,dhgk->bhgk", x_t, p["W"])
    g = g + torch.einsum("bhk,hkgj->bhgj", h, p["R"]) + p["b"]
    return _gates(g, c, n)


def slstm_fwd(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]: the input projection over the whole
    sequence, then the recurrence step by step in fp32."""
    B, S, D = x.shape
    nh = cfg.n_heads
    hd = D // nh
    xin = common.apply_norm(cfg, p["ln"], x).float()
    gx = torch.einsum("bsd,dhgk->bshgk", xin, p["W"]) + p["b"]
    c, n, h = (torch.zeros((B, nh, hd), dtype=torch.float32,
                           device=x.device) for _ in range(3))
    hs = []
    for t in range(S):
        g = gx[:, t] + torch.einsum("bhk,hkgj->bhgj", h, p["R"])
        c, n, h = _gates(g, c, n)
        hs.append(h)
    y = torch.stack(hs, 1).reshape(B, S, D)
    cdt = common.dtype_of(cfg.compute_dtype)
    return x + (y.to(cdt) @ p["out"].to(cdt)).to(x.dtype)


def init_slstm_state(cfg: ArchConfig, B: int, device):
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    return tuple(torch.zeros((B, nh, hd), dtype=torch.float32, device=device)
                 for _ in range(3))


def slstm_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor, state):
    """x [B, 1, D], one token; state (c, n, h) -> (y, the new state)."""
    xin = common.apply_norm(cfg, p["ln"], x).float()[:, 0]
    state = _slstm_cell(p, xin, state)
    y = state[2].reshape(x.shape[0], -1)
    cdt = common.dtype_of(cfg.compute_dtype)
    out = x + (y.to(cdt) @ p["out"].to(cdt))[:, None, :].to(x.dtype)
    return out, state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups, mLSTM blocks a group); each group ends in one sLSTM."""
    m = cfg.xlstm.m_per_group
    assert cfg.n_layers % (m + 1) == 0, (cfg.n_layers, m + 1)
    return cfg.n_layers // (m + 1), m


def init(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """Seeded parameters on ``device`` (default ``gen.device``) in the
    JAX package's layout (the values follow ``gen``, not the JAX PRNG)."""
    G, m = _groups(cfg)
    dev = common.init_device(gen, device)
    return {
        "tok": common.init_embed(cfg, gen, dev),
        "mlstm": common.stacked(G * m, lambda: init_mlstm(cfg, gen, dev)),
        "slstm": common.stacked(G, lambda: init_slstm(cfg, gen, dev)),
        "ln_f": common.init_norm(cfg, cfg.d_model, dev),
    }


def forward_train(cfg: ArchConfig, params: Dict, tokens, **_
                  ) -> Tuple[torch.Tensor, Dict]:
    """Logits [B, S, V] and ``aux`` (a zero ``aux_loss``), differentiable
    in ``params``.  With ``cfg.remat`` and grad mode on, each block keeps
    only its input and reruns in the backward (per-layer, as the JAX
    package checkpoints each block)."""
    G, m = _groups(cfg)
    dev = _device(params)
    x = shard_act(common.embed_tokens(cfg, params["tok"],
                                      _tokens(tokens, dev)), "residual")
    ml = common.unstack(params["mlstm"], G * m)
    sl = common.unstack(params["slstm"], G)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, lp, x):
        if remat:
            x = checkpoint(fn, cfg, lp, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = fn(cfg, lp, x)
        return shard_act(x, "residual")

    for g in range(G):
        for j in range(m):
            x = run(mlstm_fwd, ml[g * m + j], x)
        x = run(slstm_fwd, sl[g], x)
    x = common.apply_norm(cfg, params["ln_f"], x)
    logits = common.unembed(cfg, params["tok"], x)
    return logits, {"aux_loss": torch.zeros((), device=dev)}


def init_cache(cfg: ArchConfig, B: int, Smax: int = 0, dtype=torch.bfloat16,
               device=None) -> Dict:
    """Zero fp32 states on ``device`` (default cuda): ``mlstm`` {C, n,
    conv} [G m, ...] and ``slstm`` (c, n, h) [G, ...].  ``Smax`` and
    ``dtype`` are the shared cache signature's; the states hold neither."""
    G, m = _groups(cfg)
    dev = common.cache_device(device)
    return {
        "mlstm": {k: v.new_zeros((G * m,) + tuple(v.shape))
                  for k, v in init_mlstm_state(cfg, B, dev).items()},
        "slstm": tuple(v.new_zeros((G,) + tuple(v.shape))
                       for v in init_slstm_state(cfg, B, dev)),
    }


def decode_step(cfg: ArchConfig, params: Dict, tokens, cache: Dict,
                lengths) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence: (logits [B, V], the new cache).  The input
    cache is not written into; ``lengths`` is not read (no attention)."""
    G, m = _groups(cfg)
    dev = _device(params)
    x = common.embed_tokens(cfg, params["tok"],
                            _tokens(tokens, dev)[:, None])
    new_m, new_s = [], []
    for g in range(G):
        for j in range(m):
            li = g * m + j
            x, st = mlstm_decode(cfg, common.row(params["mlstm"], li), x,
                                 common.row(cache["mlstm"], li))
            new_m.append(st)
        x, st = slstm_decode(cfg, common.row(params["slstm"], g), x,
                             common.row(cache["slstm"], g))
        new_s.append(st)
    x = common.apply_norm(cfg, params["ln_f"], x)
    logits = common.unembed(cfg, params["tok"], x)[:, 0]
    return logits, {
        "mlstm": {k: torch.stack([st[k] for st in new_m])
                  for k in new_m[0]},
        "slstm": tuple(torch.stack([st[i] for st in new_s])
                       for i in range(3)),
    }
