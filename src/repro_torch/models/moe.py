"""Mixture-of-Experts FFN with sort-based dispatch.

A port of the JAX package's ``repro.models.moe``: top-k routing with a
static per-expert capacity.  The (token, choice) assignments are
flattened and stably sorted by expert id, each expert keeps its first C,
the kept tokens are gathered into a dense [E, C, D] block, all experts
run as three batched products, and each token sums its K weighted expert
outputs.  Compared with the one-hot GShard dispatch this never builds a
[T, E, C] tensor.  Aux losses: switch-style load balance, router z-loss
and the dropped share, as in JAX.

The JAX combine scatter-adds the weighted outputs into the tokens' rows.
Here every token instead gathers its own K slots and sums them in fp32 in
a fixed order, and the dispatch gather's gradient is the same gather-sum
(the two gathers are each other's transpose, ``_Pick``).  So neither
direction takes an atomic add, and on the card two runs, or a forward
and its rematerialised rerun, give bit-identical results.  Gradients
flow through the gathers and the gates, never through the sort.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig, MoEConfig
from repro_torch.distributed.ctx import shard_act
from repro_torch.models import common


def init_moe(cfg: ArchConfig, gen: torch.Generator, device=None) -> Dict:
    """The JAX package's keys and shapes: ``router`` [D, E] (fp32 always),
    ``w1`` / ``w3`` [E, D, F], ``w2`` [E, F, D] scaled by 1/sqrt(L), and
    ``shared`` (an MLP of ``d_expert * n_shared``) when there are shared
    experts."""
    m = cfg.moe
    d = cfg.d_model
    dev = common.init_device(gen, device)
    s = 0.02
    p = {
        "router": torch.randn((d, m.n_experts), generator=gen,
                              device=dev, dtype=torch.float32) * s,
        "w1": common._normal(gen, (m.n_experts, d, m.d_expert), cfg, s, dev),
        "w3": common._normal(gen, (m.n_experts, d, m.d_expert), cfg, s, dev),
        "w2": common._normal(gen, (m.n_experts, m.d_expert, d), cfg,
                             s / max(1, cfg.n_layers) ** 0.5, dev),
    }
    if m.n_shared:
        p["shared"] = common.init_mlp(cfg, gen, d_ff=m.d_expert * m.n_shared,
                                      device=dev)
    return p


def route(cfg: ArchConfig, p: Dict, xt: torch.Tensor):
    """The fp32 router over tokens ``xt`` [T, D]: (logits [T, E], probs,
    gate [T, K] renormalised over the K choices, choice [T, K] int64)."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, choice = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate, choice


def _pick(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``src[index]``, index ``len(src)`` naming a zero row; an
    [N, K] index sums each row's K picks in fp32, in order."""
    pad = torch.cat([src, src.new_zeros((1, src.shape[1]))])
    rows = pad[index]
    return rows if index.dim() == 1 else rows.float().sum(1).to(src.dtype)


class _Pick(torch.autograd.Function):
    """``_pick(src, index)`` whose gradient is ``_pick(grad, adjoint)``:
    the dispatch (a slot's token) and the combine (a token's K slots) are
    each other's transpose, so both directions are gathers."""

    @staticmethod
    def forward(ctx, src, index, adjoint):
        ctx.save_for_backward(adjoint)
        return _pick(src, index)

    @staticmethod
    def backward(ctx, grad):
        (adjoint,) = ctx.saved_tensors
        return _pick(grad, adjoint), None, None


def moe_fwd(cfg: ArchConfig, p: Dict, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict]:
    """x [B, S, D] -> (out [B, S, D], aux-loss dict).  The capacity
    C = max(1, int(T K / E * capacity_factor)) couples a batch's tokens,
    as in JAX: which tokens an expert drops depends on the others."""
    m: MoEConfig = cfg.moe
    cdt = common.dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    dev = x.device
    xt = shard_act(x.reshape(T, D), "moe_tokens")
    logits, probs, gate, choice = route(cfg, p, xt)

    # ---- sort-based dispatch (a Python int capacity: no host sync) ----
    C = max(1, int(T * K / E * m.capacity_factor))
    flat_e = choice.reshape(-1)                                 # [T*K]
    idx = torch.arange(T * K, device=dev)
    # stable: ties keep flat-slot order, as JAX's 2-key sort
    se, sperm = torch.sort(flat_e, stable=True)
    st = sperm // K                                             # token
    sg = gate.reshape(-1)[sperm]
    # position within the expert's segment
    first = torch.ones_like(se, dtype=torch.bool)
    first[1:] = se[1:] != se[:-1]
    seg_start = torch.cummax(torch.where(first, idx, -1), 0).values
    pos_in_e = idx - seg_start
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)          # E*C: drop

    # slot -> its token (T: empty) and gate; (token, choice) -> its slot
    tok_at_slot = torch.full((E * C + 1,), T, dtype=torch.long,
                             device=dev).scatter(0, slot, st)[:E * C]
    gate_at_slot = torch.zeros(E * C + 1, dtype=torch.float32,
                               device=dev).scatter(0, slot, sg)[:E * C]
    slot_of = torch.empty_like(slot).scatter_(0, sperm, slot).view(T, K)
    xe = _Pick.apply(xt, tok_at_slot, slot_of).view(E, C, D).to(cdt)
    xe = shard_act(xe, "moe_experts")      # EP: experts over model axis

    # ---- expert compute: three batched products in cdt ----------------
    act = F.silu if cfg.act == "silu" else (
        lambda a: F.gelu(a, approximate="tanh"))
    def weight(k):              # cast at its use: one bf16 copy at a time
        return shard_act(p[k].to(cdt), "moe_weight")
    h = act(torch.bmm(xe, weight("w1")))
    h = h * torch.bmm(xe, weight("w3"))
    ye = torch.bmm(h, weight("w2"))                             # [E, C, D]

    # ---- combine: each token gathers its K weighted slots -------------
    yflat = (ye.reshape(E * C, D).float() * gate_at_slot[:, None]).to(cdt)
    out = _Pick.apply(yflat, slot_of, tok_at_slot)
    out = out.to(x.dtype).reshape(B, S, D)
    if m.n_shared:
        out = out + common.mlp_fwd(cfg, p["shared"], x)

    # ---- aux losses ----------------------------------------------------
    me = probs.mean(0)                                          # [E]
    # bincount as a scatter-add of ones: the same integer counts, and a
    # shape that does not depend on the data (the dry run's meta tensors)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.float() / (T * K)
    balance = E * torch.sum(me * ce) * m.balance_coef
    z = torch.mean(torch.logsumexp(logits, -1) ** 2) * m.router_z_coef
    dropped = 1.0 - keep.float().mean()
    return out, {"moe_balance": balance, "moe_z": z, "moe_dropped": dropped}
