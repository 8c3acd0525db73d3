"""Fault tolerance: kill -9 fault injection, straggler monitoring,
crash/restart.

A port of the JAX package's ``repro.distributed.fault``.  The pieces are
host-level and deterministic, hence testable on the CPU:

  * crash_point — the kill -9 fault-injection hook the durability battery
    drives, under the JAX package's environment selector
    (``URUV_CRASH_POINT``), so one battery drives both packages alike:
    named points on the WAL append / fsync / checkpoint publish paths
    SIGKILL the process mid-operation, and recovery is exercised against
    genuinely torn on-disk state, not a polite exception.
  * StragglerMonitor — EWMA + MAD step-time detector; pluggable actions
    (shrink microbatch, flag host, trigger checkpoint).
  * run_with_restarts — crash-simulating train-loop driver: training is
    a pure function of (checkpoint, data stream step), so a restart
    reproduces the exact trajectory (the attention's backward kernel has
    no atomics, so this holds on the card too).
  * reshard — the elastic move of a state onto new placements: a whole
    leaf onto one device, or a leaf split along dim 0 over a
    ``torch.distributed`` group (:class:`GroupPlacement`, one block a
    member, as JAX's ``NamedSharding(mesh, P(axis))``), and back.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import store as S
from repro_torch.distributed import collectives as C
from repro_torch.optim.adamw import tree_map

CRASH_POINT_ENV = "URUV_CRASH_POINT"

# per-process hit counters, keyed by crash-point name — the env selector
# ``name:k`` crashes on the k-th time execution reaches ``name``
_crash_hits: Dict[str, int] = {}


def reset_crash_counters() -> None:
    """Forget per-process crash-point hit counts (test isolation)."""
    _crash_hits.clear()


def crash_point(name: str, flush: Optional[Callable[[], None]] = None) -> None:
    """Die by SIGKILL when the ``URUV_CRASH_POINT`` selector matches.

    The selector is ``<name>`` (crash on the first hit) or ``<name>:<k>``
    (crash on the k-th hit — randomized crash timing without randomizing
    the code path).  ``flush`` runs right before the kill so deliberately
    torn state (e.g. a half-written WAL record sitting in a userspace
    buffer) actually reaches the OS file — SIGKILL forfeits every Python
    buffer, which would otherwise make the torn-write points unreachable.

    A no-op (one dict lookup) when the env var is unset, so the hooks are
    safe to leave on production paths.
    """
    sel = os.environ.get(CRASH_POINT_ENV)
    if not sel:
        return
    want, _, k = sel.partition(":")
    if want != name:
        return
    hits = _crash_hits.get(name, 0) + 1
    _crash_hits[name] = hits
    if hits < (int(k) if k else 1):
        return
    if flush is not None:
        flush()
    os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float
    factor: float


class StragglerMonitor:
    """Flags steps slower than ``factor`` x running median (+ MAD guard)."""

    def __init__(self, window: int = 32, factor: float = 2.5,
                 min_samples: int = 5):
        self.window = window
        self.factor = factor
        self.min_samples = min_samples
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []
        self.actions: List[Callable[[StragglerEvent], None]] = []

    def on_straggler(self, fn: Callable[[StragglerEvent], None]) -> None:
        self.actions.append(fn)

    def record(self, step: int, duration: float) -> Optional[StragglerEvent]:
        hist = self.durations[-self.window:]
        self.durations.append(duration)
        if len(hist) < self.min_samples:
            return None
        med = statistics.median(hist)
        mad = statistics.median([abs(x - med) for x in hist]) or 1e-9
        if duration > self.factor * med and duration > med + 6 * mad:
            ev = StragglerEvent(step, duration, med, duration / med)
            self.events.append(ev)
            for fn in self.actions:
                fn(ev)
            return ev
        return None

    def timed(self, step: int):
        mon = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                mon.record(step, time.perf_counter() - self.t0)

        return _Timer()


# ---------------------------------------------------------------------------
# elastic placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupPlacement:
    """A leaf split along dim 0 into equal blocks over ``group``: member
    ``r`` keeps block ``r`` on ``device`` (default ``cuda``; raises
    without it).  A stacked store's shard axis so placed leaves each
    member its [1] block (``repro_torch.core.sharded``)."""

    group: Any
    device: Optional[torch.device] = None

    def __post_init__(self):
        object.__setattr__(self, "device", S.resolve_device(self.device))

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This member's block of the whole leaf ``x`` (a copy)."""
        n, r = C.axis_size(self.group), C.axis_index(self.group)
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(f"a leaf of shape {tuple(x.shape)} does not "
                             f"split into {n} blocks along dim 0")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b].to(self.device, copy=True)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every member's block ``x`` (on ``x``'s
        device, in every member)."""
        return C.all_gather(x, self.group).flatten(0, 1)


def _is_placement(p) -> bool:
    return p is None or isinstance(p, (torch.device, str, GroupPlacement))


def reshard(tree, placements, *, current=None):
    """Elastic move of a tree onto ``placements`` (JAX's ``reshard``: each
    whole leaf fetched, then put on its new sharding; a new mesh is fine).

    ``placements`` and ``current`` are each one placement for every leaf
    or a tree of them congruent to ``tree``.  A placement is a device
    (the whole leaf goes there) or a :class:`GroupPlacement` (this
    member keeps its block).  ``current`` says where the leaves are now:
    ``None``, whole; a :class:`GroupPlacement`, this member's block,
    gathered whole first, so ``reshard(blocks, device, current=placement)``
    is the inverse of ``reshard(whole, placement)``.  A store
    (``UruvStore``) is one leaf whose every array moves alike.
    """
    def one(x, to, now):
        if isinstance(x, S.UruvStore):
            return S.map_arrays(lambda a: one(a, to, now), x)
        if isinstance(now, GroupPlacement):
            x = now.whole(x)
        if isinstance(to, GroupPlacement):
            return to.block(x)
        return x.to(to)

    def spread(p):
        return tree_map(lambda _: p, tree) if _is_placement(p) else p

    return tree_map(one, tree, spread(placements), spread(current))


# ---------------------------------------------------------------------------
# crash / restart
# ---------------------------------------------------------------------------

def run_with_restarts(
    *,
    init_fn: Callable[[], tuple],           # () -> state
    step_fn: Callable,                      # (state, batch) -> (state, mets)
    batch_fn: Callable[[int], Dict],        # step -> batch (deterministic)
    ckpt,                                   # CheckpointManager
    total_steps: int,
    ckpt_every: int = 10,
    crash_at: Optional[List[int]] = None,   # simulated host deaths
):
    """Crash-tolerant training driver.

    On (simulated) crash: drop all live state, restore the latest complete
    checkpoint, resume the deterministic data stream at the restored step.
    Returns (final_state, per-step metrics including replays).  A restore
    takes its tree structure from the state at hand (from ``init_fn()``
    when the run starts from a checkpoint: JAX's ``eval_shape`` has no
    twin here).
    """
    crash_at = sorted(crash_at or [])
    history = []
    step = 0
    if ckpt.latest_step() is not None:
        like = init_fn()
        state, step = ckpt.restore(like)
    else:
        state = init_fn()
        ckpt.save(state, 0)
    like = tree_map(lambda _: None, state)   # names only, no memory

    while step < total_steps:
        if crash_at and step == crash_at[0]:
            crash_at.pop(0)
            ckpt.wait()
            state = None                     # simulate losing device state
            restored, rstep = ckpt.restore(like)
            history.append(("restart", step, rstep))
            state, step = restored, rstep
            continue
        batch = batch_fn(step)
        state, metrics = step_fn(state, batch)
        step += 1
        history.append(("step", step, float(metrics.get("loss", 0.0))))
        if step % ckpt_every == 0:
            ckpt.save(state, step)
    ckpt.wait()
    return state, history

