"""The execution backend of the `Uruv` client (single device).

An executor owns HOW a plan runs; the client owns the store value and the
ADT surface.  The contract mirrors the JAX package's executors:

  * ``create()``                        -> a fresh store
  * ``apply(store, batch, ...)``        -> (store, values[P], range_items)
  * ``lookup(store, keys, snap_ts)``    -> values (read-only, no clock)
  * ``range_page`` / ``scan_page``      -> RangePage (one bounded pass)
  * ``range_all``                       -> complete per-query page lists
  * ``snapshot / release / compact / reindex / ts``

``stats`` counts ``device_passes``, ``slow_path_rounds`` and
``compactions``.

The port runs the fixed-footprint policy only: the pools keep their
configured sizes, and a store that cannot fit the working set raises
``CapacityError``.  Self-sizing (pool growth and incremental maintenance,
the JAX package's default) waits for the port of ``core/lifecycle.py``
(ROADMAP); a policy that asks for it raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batch as _batch
from repro_torch.core import store as _store
from repro_torch.api.opbatch import OpBatch, RangePage

CapacityError = _batch.CapacityError


@dataclasses.dataclass(frozen=True)
class LifecyclePolicy:
    """Host-side lifecycle policy (the JAX package's fields and defaults).

    The port accepts only ``auto_grow=False, auto_maintain=False``
    (:data:`FIXED_FOOTPRINT`); the other fields are for the port of
    ``core/lifecycle.py``.
    """

    auto_grow: bool = True          # grow pools on OFLOW instead of raising
    auto_maintain: bool = True      # interleave maintain() after applies
    maintain_budget: int = 128      # leaf pairs + relocations per pass
    maintain_passes: int = 2        # max passes per interleaved trigger
    frozen_trigger: float = 0.25    # dead fraction of n_alloc that triggers
    min_dead_leaves: int = 32       # ignore dead fractions of tiny pools
    grow_occupancy: float = 0.9     # proactive: grow before the wall
    version_gc_fraction: float = 0.5  # compact() before growing versions
    pressure_passes: int = 64       # maintain burst bound under OFLOW_LEAVES


FIXED_FOOTPRINT = LifecyclePolicy(auto_grow=False, auto_maintain=False)


def _new_stats():
    return {"device_passes": 0, "slow_path_rounds": 0, "compactions": 0}


@dataclasses.dataclass(frozen=True)
class RangeOptions:
    """Leaf/result budget of one bounded range pass."""

    max_results: int = 1024
    scan_leaves: int = 16
    max_rounds: int = 8


class LocalExecutor:
    """Single-device execution over ``repro_torch.core.store`` /
    ``core.batch`` on ``device`` (default ``cuda``; raises without it)."""

    def __init__(self, config: Optional[_store.UruvConfig] = None, *,
                 device=None, policy: Optional[LifecyclePolicy] = None):
        policy = FIXED_FOOTPRINT if policy is None else policy
        if policy.auto_grow or policy.auto_maintain:
            raise NotImplementedError(
                "self-sizing stores (auto_grow / auto_maintain) come with "
                "the port of core/lifecycle.py (see ROADMAP.md); use "
                "LifecyclePolicy(auto_grow=False, auto_maintain=False)")
        self.config = config or _store.UruvConfig()
        self.device = _store.resolve_device(device)
        self.policy = policy
        self.stats = _new_stats()

    def create(self):
        return _store.create(self.config, self.device)

    def ts(self, store) -> int:
        return int(store.ts)

    # ----------------------------------------------------------------- write
    def apply(self, store, batch: OpBatch, *, light_path: bool = True,
              range_opts: RangeOptions = RangeOptions()):
        store, values, range_pages = _batch.apply_mixed(
            store, batch.codes, batch.keys, batch.values,
            light_path=light_path, max_results=range_opts.max_results,
            scan_leaves=range_opts.scan_leaves,
            max_rounds=range_opts.max_rounds, stats=self.stats,
        )
        k2 = np.asarray(batch.values)
        range_items = [(pos, page, int(k2[pos])) for pos, page in range_pages]
        return store, values, range_items

    # ------------------------------------------------------------------ read
    def lookup(self, store, keys, snap_ts):
        self.stats["device_passes"] += 1
        return _store.bulk_lookup(store, keys, snap_ts)

    def range_page(self, store, k1s, k2s, snap_ts,
                   opts: RangeOptions = RangeOptions()) -> RangePage:
        self.stats["device_passes"] += 1
        return RangePage(*_store.bulk_range(
            store, np.atleast_1d(np.asarray(k1s, np.int32)),
            np.atleast_1d(np.asarray(k2s, np.int32)), snap_ts,
            max_results=opts.max_results, scan_leaves=opts.scan_leaves,
            max_rounds=opts.max_rounds))

    def scan_page(self, store, k1: int, k2: int, snap_ts, *,
                  max_scan_leaves: int = 64,
                  max_results: int = 1024) -> RangePage:
        """The paper's single-interval bounded RANGEQUERY pass (exactly
        ``max_scan_leaves`` leaves), as a Q=1 page."""
        self.stats["device_passes"] += 1
        keys, vals, cnt, trunc = _store.range_query(
            store, k1, k2, snap_ts,
            max_scan_leaves=max_scan_leaves, max_results=max_results)
        # resume frontier: last kept key + 1 when the page has hits; a
        # truncated zero-hit page resumes at the first unscanned leaf's
        # separator (resuming at k1 would livelock)
        sep = _store.scan_resume_sep(store, k1, max_scan_leaves, k2)
        resume = torch.where(
            cnt > 0, keys[(cnt - 1).clamp_min(0)] + 1,
            torch.where(trunc, sep, torch.tensor(k1, dtype=torch.int32,
                                                 device=keys.device)))
        return RangePage(keys[None], vals[None], cnt[None], trunc[None],
                         resume[None])

    def range_all(self, store, k1s, k2s, snap_ts,
                  opts: RangeOptions = RangeOptions()
                  ) -> List[List[Tuple[int, int]]]:
        return _batch.bulk_range_all(
            store, k1s, k2s, snap_ts, max_results=opts.max_results,
            scan_leaves=opts.scan_leaves, max_rounds=opts.max_rounds,
            stats=self.stats)

    # --------------------------------------------------------- snapshots, GC
    def snapshot(self, store):
        store, ts = _store.snapshot(store)
        return store, int(ts)

    def release(self, store, snap_ts: int):
        return _store.release(store, snap_ts)

    def compact(self, store):
        self.stats["compactions"] += 1
        store, n_live = _store.compact(store)
        return store, int(n_live)

    def reindex(self, store):
        """Stop-the-world index repack; results are unchanged."""
        self.stats["reindexes"] = self.stats.get("reindexes", 0) + 1
        return _store.reindex(store)
