"""Training loop: deterministic data, checkpointing, straggler monitor.

A port of the JAX package's ``repro.train.loop``.  PyTorch runs eagerly:
the step is the plain function of ``steps.make_train_step`` (no ``jit``),
and it updates the state's tensors in place (the JAX loop donates them).
A step's time, read by the straggler monitor, runs until its loss is on
the host, so it covers the device's work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ArchConfig
from repro_torch.core.store import resolve_device
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.optim import adamw
from repro_torch.train import steps


@dataclasses.dataclass
class TrainLoopConfig:
    batch_size: int = 8
    seq_len: int = 128
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    seed: int = 0


def train(
    cfg: ArchConfig,
    loop: TrainLoopConfig,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    state: Optional[steps.TrainState] = None,
    log_fn: Callable[[str], None] = print,
    device=None,
) -> Dict:
    """Train ``cfg`` for ``loop.total_steps`` on ``device`` (default
    cuda), resuming from ``loop.ckpt_dir``'s newest checkpoint when there
    is one."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        warmup_steps=max(10, loop.total_steps // 20),
        total_steps=loop.total_steps,
    )
    step_fn = steps.make_train_step(cfg, opt_cfg)

    def init():
        return steps.init_state(
            cfg, torch.Generator(device=dev).manual_seed(loop.seed))

    start_step = 0
    ckpt = CheckpointManager(loop.ckpt_dir, device=dev) \
        if loop.ckpt_dir else None
    if state is None:
        if ckpt is not None and ckpt.latest_step() is not None:
            state, start_step = ckpt.restore(init())
            log_fn(f"restored checkpoint at step {start_step}")
        else:
            state = init()

    monitor = StragglerMonitor()
    losses = []
    t_start = time.time()
    for step in range(start_step, loop.total_steps):
        batch = make_batch(cfg, loop.batch_size, loop.seq_len, step,
                           loop.seed, device=dev)
        with monitor.timed(step):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        losses.append(loss)
        if (step + 1) % loop.log_every == 0:
            log_fn(
                f"step {step+1:5d} loss {loss:.4f} "
                f"acc {float(metrics['acc']):.3f} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"lr {float(metrics['lr']):.2e}"
            )
        if ckpt is not None and (step + 1) % loop.ckpt_every == 0:
            ckpt.save(state, step + 1)
    if ckpt is not None:
        ckpt.save(state, loop.total_steps)
        ckpt.wait()
    wall = time.time() - t_start
    return {
        "state": state,
        "losses": losses,
        "wall_s": wall,
        "straggler_events": monitor.events,
        "steps_per_s": (loop.total_steps - start_step) / max(wall, 1e-9),
    }
