"""AdamW with decoupled weight decay, global-norm clipping, LR schedules.

A port of the JAX package's ``repro.optim.adamw``.  Parameters, moments
and gradients are trees of nested dicts of tensors (``NamedTuple``s
allowed), walked in the order of ``jax.tree.leaves`` — dict keys sorted —
so the global norm sums its leaves in JAX's order.  The moments are fp32.
The learning rate and the bias corrections are fp32 tensors on the
parameters' device: JAX computes them in fp32 (x64 off), and a Python
float64 schedule would differ in the last bits.

:func:`update` writes the new parameters and moments into the given
tensors (the port's form of the JAX train loop's ``donate_argnums``): a
caller that needs the old values keeps a copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Dict
    v: Dict
    step: torch.Tensor


# ---------------------------------------------------------------------------
# trees (nested dicts / NamedTuples of tensors), in jax.tree's leaf order
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted,
    tuple fields in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the congruent ``rest``),
    keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple):
        parts = [tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return fn(tree, *rest)


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _decay_mask(params) -> Dict:
    """No weight decay on 1-D params (norm scales, biases, gates)."""
    return tree_map(lambda p: p.dim() > 1, params)


def init(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=_device(params)))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``, fp32."""
    warm = torch.clamp((step + 1).float() / max(1, cfg.warmup_steps),
                       max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps).float()
        / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree_leaves(tree)))


def update(cfg: AdamWConfig, params, grads, state: OptState
           ) -> Tuple[Dict, OptState, Dict]:
    """One AdamW step: ``(params, OptState, {"grad_norm", "lr"})``, the
    parameters and moments written in place (the returned trees are the
    given ones)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v, dm):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if dm:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    with torch.no_grad():
        for xs in zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state.m), tree_leaves(state.v),
                      tree_leaves(_decay_mask(params))):
            upd(*xs)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.m, state.v, step), metrics
