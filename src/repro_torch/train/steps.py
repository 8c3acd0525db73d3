"""Step builders: loss, train_step (grad-accum, clip, AdamW), serve steps.

A port of the JAX package's ``repro.train.steps`` for every family: a
batch holds ``tokens`` (the decoders, MoE, hybrid and xLSTM models),
``tokens`` and ``patches`` (VLM) or ``embeds`` (the encoder-only
model).
PyTorch runs eagerly, so a builder returns a plain function (nothing to
``jit``).  Gradients come from ``torch.autograd.grad`` over the
parameter leaves; on the card the attention's gradient is the
hand-written backward kernel (``kernels.flash_attention``).

``train_step`` writes the new parameters and moments into the state's
tensors (the port's form of the JAX loop's ``donate_argnums=(0,)``): at
llama3.2-1b's width a second copy of the state is 20 GB.  A caller that
needs the old state keeps a copy.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import common
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Dict
    opt: adamw.OptState
    step: torch.Tensor


def init_state(cfg: ArchConfig, gen: torch.Generator) -> TrainState:
    """Seeded parameters on ``gen.device``, zero moments, step 0."""
    params = get_model(cfg).init(cfg, gen)
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=gen.device))


def _forward(cfg: ArchConfig, params, batch):
    """``forward_train`` on the batch's inputs for the config's family."""
    fwd = get_model(cfg).forward_train
    if cfg.encoder_only:
        return fwd(cfg, params, embeds=batch["embeds"])
    if cfg.vlm is not None:
        return fwd(cfg, params, batch["tokens"], patches=batch["patches"])
    return fwd(cfg, params, batch["tokens"])


def loss_fn(cfg: ArchConfig, params, batch) -> Tuple[torch.Tensor, Dict]:
    logits, aux = _forward(cfg, params, batch)
    if cfg.vlm is not None:         # the loss is over the text rows
        logits = logits[:, cfg.vlm.n_patches:]
    loss, metrics = common.cross_entropy(logits, batch["labels"],
                                         batch["mask"])
    total = loss + aux.get("aux_loss", 0.0)
    metrics = dict(metrics, loss=loss, **{
        k: v for k, v in aux.items() if k != "aux_loss"})
    return total, metrics


def loss_and_grads(cfg: ArchConfig, params, batch) -> Tuple[Dict, Dict]:
    """(grads congruent with ``params``, metrics): ``jax.value_and_grad``
    of :func:`loss_fn` over the parameters."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = loss_fn(cfg, live, batch)
    leaves = tree_leaves(live)
    # the encoder never reads its token table: that leaf gets a zero
    # gradient, as in JAX; in every other family an unused leaf raises
    grads = torch.autograd.grad(total, leaves,
                                allow_unused=cfg.encoder_only)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)}
    return (tree_map(lambda p: by_leaf[id(p)], live),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    cfg.accum_steps > 1 runs gradient accumulation over microbatches (the
    global batch is split on its leading dim inside the step), bounding
    activation memory.
    """

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        A = cfg.accum_steps
        if A > 1:
            micro = {k: v.reshape((A, v.shape[0] // A) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            metrics = None
            for a in range(A):
                g, mets = loss_and_grads(
                    cfg, state.params, {k: v[a] for k, v in micro.items()})
                grads = tree_map(lambda x, y: x + y.float() / A, grads, g)
                if metrics is None:
                    metrics = {k: torch.zeros_like(v) for k, v in
                               mets.items()}
                metrics = {k: metrics[k] + mets[k] / A for k in metrics}
        else:
            grads, metrics = loss_and_grads(cfg, state.params, batch)

        params, opt, opt_metrics = adamw.update(
            opt_cfg, state.params, grads, state.opt)
        metrics = dict(metrics, **opt_metrics)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """Inference prefill: logits for a full prompt batch (no labels; a
    VLM's include its patch rows)."""
    get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch) -> torch.Tensor:
        return _forward(cfg, params, batch)[0]

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One decode step: greedy next token + updated cache."""
    api = get_model(cfg)
    assert api.decode_step is not None, f"{cfg.name} has no decode step"

    @torch.no_grad()
    def serve_step(params, batch):
        logits, cache = api.decode_step(
            cfg, params, batch["tokens"], batch["cache"], batch["lengths"])
        next_tok = torch.argmax(logits, dim=-1).int()
        return {
            "tokens": next_tok,
            "lengths": batch["lengths"] + 1,
            "cache": cache,
            "logits": logits,
        }

    return serve_step
