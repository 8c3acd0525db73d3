"""Mamba2 (SSD) block: the chunked-parallel training form and the
recurrent decode step.

A port of the JAX package's ``repro.models.mamba2``.  Per head the
scalar-decay state-space recurrence is

    h_t = a_t * h_{t-1} + u_t ⊗ B_t          h: [P, N]
    y_t = (h_t @ C_t) + D * x_t

with a_t = exp(A·dt_t) in (0, 1] and u_t = dt_t * x_t.  Training runs
the chunked decomposition (chunk Q): inside a chunk an attention-like
[Q, Q] masked product, across chunks a loop over S/Q boundary states.
Decode is the plain one-step recurrence, in fp32.

``ssd_chunked`` is shared with the mLSTM block (``models.xlstm``).  It
rounds each product's operands to bf16 and multiplies them in fp32, as
the JAX einsums do with bf16 operands and ``preferred_element_type=
float32``: a product of two or three bf16 values is exact in fp32, so
only the order of summation differs from the JAX package.  On the card
this needs TF32 off (PyTorch's default for ``matmul``).

The JAX package has no Pallas kernel for this block: it is PyTorch code
here as there it is ``jnp.einsum`` and ``lax.scan``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models import common


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _bf(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, held in fp32."""
    return x.to(torch.bfloat16).float()


def ssd_chunked(u: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u [B, S, H, P]; a [B, S, H] decay; Bm / Cm [B, S, H, N] ->
    (y [B, S, H, P] fp32, the last state [B, H, P, N] fp32).

    Exact evaluation of the recurrence above from a zero state."""
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, f"seq {S} % chunk {Q} != 0"
    nc = S // Q

    def r(x):
        return x.reshape((B, nc, Q) + tuple(x.shape[2:]))

    u_, a_, B_, C_ = r(u), r(a), r(Bm), r(Cm)
    la = torch.log(torch.clamp_min(a_, 1e-20)).float()          # [B,nc,Q,H]
    cum = torch.cumsum(la, dim=2)                               # inclusive

    # intra-chunk: score[i, j] = (C_i . B_j) exp(cum_i - cum_j), j <= i
    scores = torch.einsum("bcqhn,bckhn->bchqk", _bf(C_), _bf(B_))
    cumh = cum.permute(0, 1, 3, 2)                              # [B,nc,H,Q]
    decay = torch.exp(cumh[..., :, None] - cumh[..., None, :])
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    w = torch.where(mask, scores * decay, 0.0)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", _bf(w), _bf(u_))

    # inter-chunk: chunk c adds sum_j exp(cum_last - cum_j) u_j ⊗ B_j
    tail = torch.exp(cum[:, :, -1:, :] - cum)                   # [B,nc,Q,H]
    chunk_state = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", _bf(tail),
                               _bf(u_), _bf(B_))                # [B,nc,H,P,N]
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [B,nc,H]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=u.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)                                          # entering c
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_in = torch.stack(h_in, 1)                                 # [B,nc,H,P,N]
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", _bf(C_), _bf(h_in)) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, h


def ssd_recurrent_step(h: torch.Tensor, u_t: torch.Tensor,
                       a_t: torch.Tensor, B_t: torch.Tensor,
                       C_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. h [B, H, P, N]; u_t [B, H, P]; a_t [B, H];
    B_t / C_t [B, H, N] -> (h', y [B, H, P])."""
    h = h * a_t[:, :, None, None] + u_t[..., :, None] * B_t[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, C_t)
    return h, y


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, conv channels)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, d_inner + 2 * s.d_state


def init_block(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """The JAX package's keys and shapes; ``A_log``, ``dt_bias`` and ``D``
    are fp32 whatever ``param_dtype`` is."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, convdim = _dims(cfg)
    dev = common.init_device(gen, device)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "ln": common.init_norm(cfg, d, dev),
        "in_proj": common._normal(
            gen, (d, 2 * d_inner + 2 * s.d_state + H), cfg, 0.02, dev),
        "conv_w": common._normal(gen, (s.d_conv, convdim), cfg, 0.2, dev),
        "conv_b": torch.zeros(convdim, dtype=common.dtype_of(cfg.param_dtype),
                              device=dev),
        "A_log": torch.zeros(H, **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),
        "D": torch.ones(H, **f32),
        "out_norm": common.init_norm(cfg, d_inner, dev),
        "out_proj": common._normal(gen, (d_inner, d), cfg,
                                   0.02 / max(1, cfg.n_layers) ** 0.5, dev),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: 2 * d_inner + 2 * s.d_state]
    dt = proj[..., 2 * d_inner + 2 * s.d_state:]
    return z, xbc, dt, d_inner, H


def block_fwd(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] (training / prefill, chunked)."""
    s = cfg.ssm
    cdt = common.dtype_of(cfg.compute_dtype)
    Bsz, S, _ = x.shape
    h = common.apply_norm(cfg, p["ln"], x).to(cdt)
    proj = h @ p["in_proj"].to(cdt)
    z, xbc, dt, d_inner, H = _split_proj(cfg, proj)

    # causal depthwise conv over the sequence, K shifted products in cdt
    K = s.d_conv
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    w = p["conv_w"].to(cdt)
    conv = sum(pad[:, i: i + S, :] * w[i][None, None, :] for i in range(K)) \
        + p["conv_b"].to(cdt)
    conv = F.silu(conv)
    xs = conv[..., :d_inner].reshape(Bsz, S, H, s.head_dim)
    shape = (Bsz, S, H, s.d_state)
    Bm = conv[..., d_inner: d_inner + s.d_state][:, :, None, :].expand(shape)
    Cm = conv[..., d_inner + s.d_state:][:, :, None, :].expand(shape)

    dt = _softplus(dt.float() + p["dt_bias"])                   # [B,S,H]
    A = -torch.exp(p["A_log"])                                  # [H]
    a = torch.exp(A[None, None, :] * dt)
    u = xs.float() * dt[..., None]

    y, _ = ssd_chunked(u, a, Bm, Cm, s.chunk)
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(cdt)
    y = y * F.silu(z)
    y = common.apply_norm(cfg, p["out_norm"], y)
    out = y @ p["out_proj"].to(cdt)
    return x + out.to(x.dtype)


def init_state(cfg: ArchConfig, B: int, device) -> Dict:
    """A zero decode state: ``h`` [B, H, P, N] and the conv window
    ``conv`` [B, K - 1, channels], both fp32."""
    s = cfg.ssm
    _, H, convdim = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((B, H, s.head_dim, s.d_state), **f32),
            "conv": torch.zeros((B, s.d_conv - 1, convdim), **f32)}


def block_decode(cfg: ArchConfig, p: Dict, x: torch.Tensor, state: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """x [B, 1, D], one token -> (y [B, 1, D], the new state).  The conv
    and the recurrence run in fp32; the input state is not written."""
    s = cfg.ssm
    cdt = common.dtype_of(cfg.compute_dtype)
    Bsz = x.shape[0]
    h = common.apply_norm(cfg, p["ln"], x).to(cdt)
    proj = (h @ p["in_proj"].to(cdt))[:, 0]
    z, xbc, dt, d_inner, H = _split_proj(cfg, proj)

    hist = torch.cat([state["conv"], xbc[:, None, :].float()], 1)  # [B,K,C]
    conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"].float())
    conv = F.silu(conv + p["conv_b"].float())

    xs = conv[:, :d_inner].reshape(Bsz, H, s.head_dim)
    shape = (Bsz, H, s.d_state)
    Bm = conv[:, None, d_inner: d_inner + s.d_state].expand(shape)
    Cm = conv[:, None, d_inner + s.d_state:].expand(shape)
    dt = _softplus(dt.float() + p["dt_bias"])                   # [B,H]
    A = -torch.exp(p["A_log"])
    a = torch.exp(A[None, :] * dt)
    u = xs * dt[..., None]
    hstate, y = ssd_recurrent_step(state["h"], u, a, Bm, Cm)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(Bsz, d_inner).to(cdt)
    y = y * F.silu(z)
    y = common.apply_norm(cfg, p["out_norm"], y)
    out = (y @ p["out_proj"].to(cdt))[:, None, :]
    return x + out.to(x.dtype), {"h": hstate, "conv": hist[:, 1:]}
