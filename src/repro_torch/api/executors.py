"""The execution backends of the `Uruv` client.

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

``durability`` is the write-ahead log sidecar of a durable client (None
for a volatile one): ``apply`` logs every committed plan through it
before returning.

``stats`` counts ``device_passes``, ``slow_path_rounds``,
``compactions`` and the lifecycle trio ``grows`` / ``maintain_passes`` /
``leaves_reclaimed``.

The store is self-sizing by default (``LifecyclePolicy()``, as in the
JAX client): capacity pressure grows the rejected pool and bounded
``maintain`` passes run when the dead fraction of the leaf pool crosses
the trigger.  :data:`FIXED_FOOTPRINT` keeps the configured pools, and a
store that cannot fit the working set raises ``CapacityError``.

`LocalExecutor` runs on one store via ``repro_torch.core.batch``;
`ShardedExecutor` runs the same plans over a key-range-sharded store
(``repro_torch.core.sharded``: routed or replicated announce
distribution, merged range passes) with bit-identical linearization,
version timestamps included: all shards stacked in one process, or one
shard a process over a ``torch.distributed`` group, where every member
runs every verb and gets the whole answer.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import batch as _batch
from repro_torch.core import lifecycle as _lifecycle
from repro_torch.core import sharded as _sharded
from repro_torch.core import store as _store
from repro_torch.api.opbatch import OpBatch, RangePage
from repro_torch.distributed import collectives as _collectives

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

    gather = None          # one process: no group to read counters over

    def __init__(self, config: Optional[_store.UruvConfig] = None, *,
                 device=None, policy: Optional[LifecyclePolicy] = None):
        self.config = config or _store.UruvConfig()
        self.device = _store.resolve_device(device)
        self.policy = policy if policy is not None \
            else _lifecycle.DEFAULT_POLICY
        self.stats = _new_stats()
        # durability sidecar (repro_torch.durability.recovery.Durability),
        # attached by Uruv(durable_dir=...) / Uruv.recover(): every
        # committed plan is logged to the WAL before its result reaches
        # the caller
        self.durability = None

    def create(self):
        return _store.create(self.config, self.device)

    def ts(self, store) -> int:
        with tracing.host_read("api.clock"):
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
        base = self.ts(store) if self.durability is not None else 0
        store, values, range_pages = _batch.apply_mixed(
            store, batch.codes, batch.keys, batch.values,
            light_path=light_path, max_results=range_opts.max_results,
            scan_leaves=range_opts.scan_leaves,
            max_rounds=range_opts.max_rounds, stats=self.stats,
            policy=self.policy,
        )
        store = self.lifecycle_tick(store)
        if self.durability is not None and len(batch):
            # log-on-commit: apply_mixed either applied the WHOLE plan or
            # raised — a logged record is a committed plan, and it hits
            # the WAL before the caller sees the result (the sync half of
            # the confirm-after-fsync contract; the pipelined half is
            # Uruv.confirm).  The fsync cadence is the sidecar's
            # group-commit window (1 = every plan).
            self.durability.log_plan(
                base, np.asarray(batch.codes), np.asarray(batch.keys),
                np.asarray(batch.values))
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

    def live_items(self, store) -> List[Tuple[int, int]]:
        return _store.live_items(store)


class ShardedExecutor:
    """Key-range-sharded execution (``repro_torch.core.sharded``) over the
    shards of ``mesh``'s data axis: stacked on ``mesh.device``, or, with
    ``mesh.group``, this process's shard (its [1] block) on its own
    device, every verb run by every member of the group alike and giving
    each the whole answer.

    Wraps the sharded passes — ``make_routed_apply`` (used first when the
    global width divides the shard count), ``make_apply`` (the replicated
    fallback) and ``make_range_apply`` (per-shard ``bulk_range`` + the
    frontier-clamped merge) — behind the same contract as
    `LocalExecutor`, so `Uruv` callers never branch on topology.
    Linearization is bit-identical to single-device execution, version
    timestamps included (per-op global timestamps + the replicated clock).

    Lifecycle decisions are REPLICATED across shards: the stacked store has
    one shape, so ``grow`` doubles every shard's pools in the same call
    and ``maintain`` runs on every shard — shard shapes never diverge, and
    since lifecycle passes touch neither the clock nor version timestamps,
    sharded execution stays bit-identical to local execution even when
    the two interleave different grow/maintain schedules.  Capacity
    rejections relieve the flagged pool and retry, bounded by
    ``MAX_SLOWPATH_ROUNDS``; with ``auto_grow=False`` a fully rejected
    announce raises ``CapacityError`` (there is no sharded halving slow
    path).  Over a group the lifecycle's counters are read across the
    members (``gather``), so every member decides from the numbers the
    stacked store reads and the blocks keep one shape.
    """

    def __init__(self, config: _sharded.ShardedConfig, mesh, *,
                 route_factor: int = 2, routed: bool = True,
                 policy: Optional[LifecyclePolicy] = None):
        self.config = config
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.shape[config.axis_name]
        self.group = mesh.group
        # stacks a member's counters over the group (lifecycle.across)
        self.gather = None if mesh.group is None else functools.partial(
            _collectives.all_gather, group=mesh.group)
        self.route_factor = route_factor
        self.routed = routed
        self.policy = policy if policy is not None \
            else _lifecycle.DEFAULT_POLICY
        self.stats = _new_stats()
        self.durability = None          # sharded clients are volatile
        self._apply_fns = {light: _sharded.make_apply(
            config, mesh, light_path=light) for light in (True, False)}
        self._routed_fns = {light: _sharded.make_routed_apply(
            config, mesh, route_factor=route_factor, light_path=light)
            for light in (True, False)}
        _, self._lookup_fn, _ = _sharded.make_ops(config, mesh)

    # ------------------------------------------------------------- lifecycle
    def create(self):
        return _sharded.create(self.config, self.mesh)

    def ts(self, store) -> int:
        return _sharded.global_ts(store)

    def _set_ts(self, store, ts: int):
        return dataclasses.replace(store, ts=torch.full_like(store.ts, ts))

    def grow(self, store, *, leaves: bool = False, versions: bool = False,
             tracker: bool = False):
        """Double the selected pools on EVERY shard (shard shapes stay
        equal — the replicated-decision rule)."""
        self.stats["grows"] += 1
        return _lifecycle.grow(store, leaves=leaves, versions=versions,
                               tracker=tracker)

    def maintain(self, store, budget: Optional[int] = None, *,
                 phase: int = 0):
        """One incremental maintenance pass over all shards."""
        store, reclaimed, merged = _lifecycle.maintain(
            store,
            budget if budget is not None else self.policy.maintain_budget,
            phase=phase, gather=self.gather)
        self.stats["maintain_passes"] += 1
        self.stats["leaves_reclaimed"] += reclaimed
        return store, reclaimed, merged

    def lifecycle_tick(self, store):
        return _lifecycle.lifecycle_tick(
            store, self.policy, stats=self.stats,
            grow_fn=lambda st: self.grow(st, leaves=True),
            gather=self.gather)

    # ----------------------------------------------------------------- write
    def _apply_crud(self, store, codes, keys, values, light_path: bool):
        """One CRUD segment at the replicated clock's timestamps (op i at
        ``store.ts + i``; the shared apply_mixed loop restates the clock
        after range segments).  A capacity rejection relieves pressure on
        every shard at once and retries — lifecycle steps never move the
        clock, so the retry applies at the rejected pass's timestamps."""
        routed = (self._routed_fns[light_path]
                  if self.routed and len(codes) % self.n_shards == 0
                  else None)
        for _ in range(_batch.MAX_SLOWPATH_ROUNDS):
            try:
                return _sharded.sharded_apply_batch(
                    store, codes, keys, values,
                    apply_fn=self._apply_fns[light_path], routed_fn=routed,
                    stats=self.stats, group=self.group)
            except RuntimeError as e:    # full rejection: relieve + retry
                reason = getattr(e, "oflow_reason", 0)
                grow_bits = reason & (_store.OFLOW_LEAVES
                                      | _store.OFLOW_VERSIONS)
                index_bit = reason & _store.OFLOW_INDEX
                # reindex is reclamation, not growth: allowed under every
                # policy; pool doubling stays behind auto_grow
                if not (index_bit or (self.policy.auto_grow and grow_bits)):
                    raise CapacityError(str(e), store=store, oflow=reason,
                                        gather=self.gather) from e
                self.stats["slow_path_rounds"] += 1
                relief = index_bit | (
                    grow_bits if self.policy.auto_grow else 0)
                store = _lifecycle.relieve_pressure(
                    store, relief, len(codes), self.policy, stats=self.stats,
                    gather=self.gather)
        raise CapacityError("sharded capacity retries failed to converge",
                            store=store, gather=self.gather)

    def apply(self, store, batch: OpBatch, *, light_path: bool = True,
              range_opts: RangeOptions = RangeOptions()):
        # ONE copy of the announce-segmentation semantics: the shared
        # core.batch.apply_mixed loop, with the sharded passes as its hooks
        store, values, range_pages = _batch.apply_mixed(
            store, batch.codes, batch.keys, batch.values,
            crud_fn=lambda st, c, k, v, op_ts, next_ts:
                self._apply_crud(st, c, k, v, light_path),
            range_all_fn=lambda st, k1, k2, snaps:
                self.range_all(st, k1, k2, snaps, range_opts),
            get_ts_fn=self.ts, set_ts_fn=self._set_ts)
        store = self.lifecycle_tick(store)
        k2 = np.asarray(batch.values)
        range_items = [(pos, page, int(k2[pos])) for pos, page in range_pages]
        return store, values, range_items

    def apply_nowait(self, store, batch: OpBatch, *,
                     donate_store: bool = False):
        """Sharded passes route and collect on the host, so a deferred
        dispatch is not available; the coalescer detects this and falls
        back to coalesced synchronous :meth:`apply` plans."""
        raise NotImplementedError(
            "apply_nowait is single-device only; use apply()")

    # ------------------------------------------------------------------ read
    def lookup(self, store, keys, snap_ts):
        self.stats["device_passes"] += 1
        keys = np.atleast_1d(np.asarray(keys, np.int32))
        return self._lookup_fn(store, keys, snap_ts)

    def range_page(self, store, k1s, k2s, snap_ts,
                   opts: RangeOptions = RangeOptions()) -> RangePage:
        k1 = np.atleast_1d(np.asarray(k1s, np.int32))
        k2 = np.atleast_1d(np.asarray(k2s, np.int32))
        snaps = np.broadcast_to(np.asarray(snap_ts, np.int32),
                                k1.shape).copy()
        fn = _sharded.make_range_apply(
            self.config, self.mesh, max_results=opts.max_results,
            scan_leaves=opts.scan_leaves, max_rounds=opts.max_rounds)
        self.stats["device_passes"] += 1
        return RangePage(*fn(store, k1, k2, snaps))

    def scan_page(self, store, k1: int, k2: int, snap_ts, *,
                  max_scan_leaves: int = 64,
                  max_results: int = 1024) -> RangePage:
        opts = RangeOptions(max_results=max_results,
                            scan_leaves=max_scan_leaves, max_rounds=1)
        return self.range_page(store, [k1], [k2], snap_ts, opts)

    def range_all(self, store, k1s, k2s, snap_ts,
                  opts: RangeOptions = RangeOptions()
                  ) -> List[List[Tuple[int, int]]]:
        """Complete Q-interval answers: the shared ``bulk_range_all``
        pagination loop driven by the merged sharded pass."""
        def page_fn(st, lo, hi, sn):
            page = self.range_page(st, lo, hi, sn, opts)
            return (page.keys, page.values, page.count, page.truncated,
                    page.resume_k1)

        return _batch.bulk_range_all(store, k1s, k2s, snap_ts,
                                     page_fn=page_fn)

    # --------------------------------------------------------- snapshots, GC
    def snapshot(self, store):
        if (self.policy.auto_grow
                and int(store.trk_active[0].sum()) >= store.cfg.tracker_cap):
            store = self.grow(store, tracker=True)   # replicated ring full
        return _sharded.sharded_snapshot(store)

    def release(self, store, snap_ts: int):
        return _sharded.sharded_release(store, snap_ts)

    def compact(self, store):
        self.stats["compactions"] += 1
        store, n_live = _store.compact(store)
        return store, int(_lifecycle.across(n_live.sum().reshape(1),
                                            self.gather).sum())

    def reindex(self, store):
        """Repack every shard's index (replicated decision: shard shapes
        stay equal, results unchanged)."""
        self.stats["reindexes"] = self.stats.get("reindexes", 0) + 1
        return _store.reindex(store)

    def live_items(self, store) -> List[Tuple[int, int]]:
        """Every shard's (key, value) pairs in key order (every member's,
        gathered, over a group)."""
        items = [kv for st in _store.shard_views(store)
                 for kv in _store.live_items(st)]
        if self.group is not None:
            rows = torch.tensor(items, dtype=torch.int64,
                                device=self.device).reshape(-1, 2)
            items = [tuple(kv) for kv in _collectives.gather_rows(
                rows, self.group).tolist()]
        return sorted(items)
