"""The execution backend of the `Uruv` client (single device).

An executor owns HOW a plan runs; the client owns the store value and the
ADT surface.  The contract mirrors the JAX package's executors:

  * ``create()``                        -> a fresh store
  * ``apply(store, batch, ...)``        -> (store, values[P], range_items)
  * ``apply_nowait(store, batch)``      -> (store, values, ok), one pass
  * ``lookup(store, keys, snap_ts)``    -> values (read-only, no clock)
  * ``range_page`` / ``scan_page``      -> RangePage (one bounded pass)
  * ``range_all``                       -> complete per-query page lists
  * ``snapshot / release / compact / reindex / ts``
  * ``grow / maintain / lifecycle_tick`` — the store lifecycle

``stats`` counts ``device_passes``, ``slow_path_rounds``,
``compactions`` and the lifecycle trio ``grows`` / ``maintain_passes`` /
``leaves_reclaimed``.

The store is self-sizing by default (``LifecyclePolicy()``, as in the
JAX client): capacity pressure grows the rejected pool and bounded
``maintain`` passes run when the dead fraction of the leaf pool crosses
the trigger.  :data:`FIXED_FOOTPRINT` keeps the configured pools, and a
store that cannot fit the working set raises ``CapacityError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batch as _batch
from repro_torch.core import lifecycle as _lifecycle
from repro_torch.core import store as _store
from repro_torch.api.opbatch import OpBatch, RangePage

CapacityError = _batch.CapacityError


LifecyclePolicy = _lifecycle.LifecyclePolicy
FIXED_FOOTPRINT = LifecyclePolicy(auto_grow=False, auto_maintain=False)


def _new_stats():
    return {"device_passes": 0, "slow_path_rounds": 0, "compactions": 0,
            "grows": 0, "maintain_passes": 0, "leaves_reclaimed": 0}


@dataclasses.dataclass(frozen=True)
class RangeOptions:
    """Leaf/result budget of one bounded range pass."""

    max_results: int = 1024
    scan_leaves: int = 16
    max_rounds: int = 8


class LocalExecutor:
    """Single-device execution over ``repro_torch.core.store`` /
    ``core.batch`` on ``device`` (default ``cuda``; raises without it).

    ``policy`` is the store lifecycle: the default self-sizing policy
    grows the rejected pool on capacity overflow and interleaves bounded
    ``maintain`` passes; :data:`FIXED_FOOTPRINT` keeps the configured
    pools.  The live capacities are ``store.cfg``; ``config`` keeps the
    initial sizes once the store has grown.
    """

    def __init__(self, config: Optional[_store.UruvConfig] = None, *,
                 device=None, policy: Optional[LifecyclePolicy] = None):
        self.config = config or _store.UruvConfig()
        self.device = _store.resolve_device(device)
        self.policy = policy if policy is not None \
            else _lifecycle.DEFAULT_POLICY
        self.stats = _new_stats()

    def create(self):
        return _store.create(self.config, self.device)

    def ts(self, store) -> int:
        return int(store.ts)

    # ------------------------------------------------------------- lifecycle
    def grow(self, store, *, leaves: bool = False, versions: bool = False,
             tracker: bool = False):
        self.stats["grows"] += 1
        return _lifecycle.grow(store, leaves=leaves, versions=versions,
                               tracker=tracker)

    def maintain(self, store, budget: Optional[int] = None, *,
                 phase: int = 0):
        store, reclaimed, merged = _lifecycle.maintain(
            store,
            budget if budget is not None else self.policy.maintain_budget,
            phase=phase)
        self.stats["maintain_passes"] += 1
        self.stats["leaves_reclaimed"] += reclaimed
        return store, reclaimed, merged

    def lifecycle_tick(self, store):
        """The post-apply lifecycle interleave: a bounded maintain burst on
        the frozen-fraction trigger, then proactive growth ahead of the
        allocator wall (both policy-gated; results are unaffected).  The
        serving pipeline calls it between plans."""
        return _lifecycle.lifecycle_tick(
            store, self.policy, stats=self.stats,
            grow_fn=lambda st: self.grow(st, leaves=True))

    # ----------------------------------------------------------------- write
    def apply(self, store, batch: OpBatch, *, light_path: bool = True,
              range_opts: RangeOptions = RangeOptions()):
        store, values, range_pages = _batch.apply_mixed(
            store, batch.codes, batch.keys, batch.values,
            light_path=light_path, max_results=range_opts.max_results,
            scan_leaves=range_opts.scan_leaves,
            max_rounds=range_opts.max_rounds, stats=self.stats,
            policy=self.policy,
        )
        store = self.lifecycle_tick(store)
        k2 = np.asarray(batch.values)
        range_items = [(pos, page, int(k2[pos])) for pos, page in range_pages]
        return store, values, range_items

    def apply_nowait(self, store, batch: OpBatch, *,
                     donate_store: bool = False):
        """ONE fast-path pass for a CRUD-only plan: ``(store, values,
        ok)``.  Rejection handling (slow path, lifecycle) is the caller's,
        through ``Uruv.confirm`` and a replay via :meth:`apply`.

        ``ok`` is already a host bool here: the port's ``bulk_apply``
        reads its overflow flags on the host (ROADMAP: the sync-free
        pass).  ``donate_store`` is accepted and changes nothing, since a
        pass never writes into its input tensors.
        """
        self.stats["device_passes"] += 1
        return _store.bulk_apply(store, batch.codes, batch.keys,
                                 batch.values)

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
        # proactive tracker growth: a full ring would silently drop the
        # registration (OFLOW_TRACKER) — grow it first instead
        if (self.policy.auto_grow
                and int(store.trk_active.sum()) >= store.cfg.tracker_cap):
            store = self.grow(store, tracker=True)
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
