"""`Uruv` — the one front door to the paper's ADT, in PyTorch.

    from repro_torch.api import OpBatch, Uruv, UruvConfig

    db = Uruv(UruvConfig(leaf_cap=32))          # on cuda; device="cpu" too
    db.insert([1, 2, 3], [10, 20, 30])
    res = db.apply(OpBatch.concat(
        OpBatch.searches([2]), OpBatch.deletes([1]), OpBatch.ranges(0, 99),
    ))                       # one linearized announce array
    with db.snapshot() as ts:            # registered + auto-released
        page = db.range(0, 99, ts)       # consistent under later updates

The client holds the current store (every earlier store stays a valid
frozen snapshot: passes never write into their inputs) and adds the
announce-order timestamp accounting and the snapshot-tracker hygiene.
The store is self-sizing by default (pools grow on pressure, bounded
``maintain`` passes reclaim retired leaves); the pipelined verbs
``apply_nowait`` / ``confirm`` serve ``repro_torch.serve.coalescer``.

A client made with ``durable_dir=...`` logs every committed plan to a
write-ahead log before its result is released and checkpoints on
``checkpoint()``; ``Uruv.recover(dir)`` rebuilds it after a crash, bit
for bit (``repro_torch.durability``, in the JAX package's on-disk
format).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import store as _store
from repro_torch.core.ref import KEY_MAX, OP_RANGE
from repro_torch.api.executors import (
    LifecyclePolicy, LocalExecutor, RangeOptions,
)
from repro_torch.api.futures import PendingPlan
from repro_torch.api.opbatch import (
    OpBatch, RangePage, Result, make_result, pow2_width,
)


class Uruv:
    """Stateful client over an immutable store + a single-device executor.

    Runs on ``device`` (default ``cuda``; raises when CUDA is absent,
    ``device="cpu"`` gives the plain PyTorch path).  The store is
    SELF-SIZING by default: capacity pressure grows the flagged pool
    (power-of-two doubling, bit-exact) and incremental ``maintain``
    passes reclaim retired leaves when the dead fraction crosses the
    policy trigger, so a client made with a small ``UruvConfig`` serves a
    large working set without ``CapacityError``.  Pass
    ``policy=LifecyclePolicy(auto_grow=False, auto_maintain=False)``
    (``FIXED_FOOTPRINT``) to keep the configured pools.
    """

    def __init__(self, config: Optional[_store.UruvConfig] = None, *,
                 device=None, store=None,
                 policy: Optional[LifecyclePolicy] = None,
                 durable_dir=None, group_commit: int = 1):
        if store is not None:
            config = config or store.cfg
            device = store.device if device is None else device
        self.executor = LocalExecutor(config, device=device, policy=policy)
        self._store = store if store is not None else self.executor.create()
        self.recovery = None       # set by Uruv.recover()
        if durable_dir is not None:
            from repro_torch.durability.recovery import Durability

            dur = Durability(durable_dir, group_commit=group_commit,
                             device=self.executor.device)
            if dur.has_history:
                raise ValueError(
                    f"{durable_dir} already holds durable history; a fresh "
                    "client would fork it — use Uruv.recover()")
            dur.write_config(self.config)
            self._attach_durability(dur)

    # ----------------------------------------------------------- constructors
    @classmethod
    def from_store(cls, store, *,
                   policy: Optional[LifecyclePolicy] = None) -> "Uruv":
        """Adopt an existing store on its own device (no copy: a pass
        never writes into its input, so the donor keeps its snapshot)."""
        return cls(store.cfg, store=store, policy=policy)

    @classmethod
    def recover(cls, durable_dir, *, device=None,
                policy: Optional[LifecyclePolicy] = None,
                group_commit: int = 1) -> "Uruv":
        """Rebuild a ``durable_dir=...`` client after a crash on
        ``device`` (default ``cuda``): restore the newest complete
        checkpoint (full or delta chain), replay the WAL tail at its
        recorded timestamps — bit-identical values AND version timestamps
        — and keep logging into the same directory.  The
        :class:`repro_torch.durability.recovery.RecoveryInfo` lands on
        ``db.recovery``."""
        from repro_torch.durability.recovery import recover as _recover

        return _recover(durable_dir, device=device, policy=policy,
                        group_commit=group_commit)

    # ------------------------------------------------------------ durability
    def _attach_durability(self, durability) -> None:
        self.executor.durability = durability

    @property
    def durability(self):
        """The attached durability sidecar (None for a volatile client)."""
        return self.executor.durability

    def sync_durable(self) -> None:
        """Close the group-commit window: fsync every logged plan still
        pending.  A no-op for a volatile client."""
        dur = self.durability
        if dur is not None:
            dur.sync()

    def checkpoint(self, *, delta: bool = True) -> int:
        """Checkpoint the current store into the durable directory (a
        delta against the previous checkpoint when one exists; the first
        save is always full) and prune WAL segments the checkpoint
        covers.  Returns the checkpoint step (the store clock)."""
        dur = self.durability
        if dur is None:
            raise ValueError(
                "checkpoint() requires a durable client "
                "(Uruv(durable_dir=...) or Uruv.recover())")
        return dur.checkpoint(
            self._store, delta=delta,
            compactions=self.executor.stats.get("compactions", 0))

    # ----------------------------------------------------------------- state
    @property
    def store(self):
        """The current store (an immutable snapshot)."""
        return self._store

    @property
    def config(self):
        return self.executor.config

    @property
    def stats(self):
        """Executor counters (``device_passes`` / ``slow_path_rounds`` /
        ``compactions`` / ``grows`` / ``maintain_passes`` /
        ``leaves_reclaimed``) plus the store's index counters
        ``index_delta_passes`` and ``index_propagations``."""
        s = dict(self.executor.stats)
        s["index_delta_passes"] = int(self._store.index.stat_delta_passes)
        s["index_propagations"] = int(self._store.index.stat_propagations)
        return s

    @property
    def capacity(self):
        """The LIVE capacities (``store.cfg``): they move as the store
        grows; the construction-time config keeps the initial sizes."""
        return self._store.cfg

    @property
    def ts(self) -> int:
        """The global clock (the paper's FAA counter)."""
        return self.executor.ts(self._store)

    @property
    def active_snapshots(self) -> int:
        """Registered-and-unreleased snapshots in the version tracker."""
        return int(self._store.trk_active.sum())

    # ----------------------------------------------------------------- write
    def apply(self, batch: OpBatch, *, light_path: bool = True,
              pad_to_pow2: bool = False,
              range_opts: RangeOptions = RangeOptions()) -> Result:
        """Linearize one announce array: op i at timestamp ``ts + i``.

        One pass on the fast path (CRUD-only batches); RANGE ops segment
        the array and are answered completely.  ``pad_to_pow2`` NOP-pads
        the plan to the next power-of-two width (results keep the
        caller's width; the clock advances by the padded width).
        """
        base = self.ts
        n = len(batch)
        if pad_to_pow2 and n:
            batch = batch.pad_to(pow2_width(n))
        self._store, values, range_items = self.executor.apply(
            self._store, batch, light_path=light_path, range_opts=range_opts)
        return make_result(values[:n], batch.codes[:n], base, range_items)

    # ------------------------------------------------- pipelined (deferred)
    def apply_nowait(self, batch: OpBatch, *, pad_to_pow2: bool = False,
                     donate_store: bool = False) -> PendingPlan:
        """Dispatch a CRUD-only plan and return a :class:`PendingPlan`; the
        client adopts the speculative store so the next plan can go out
        behind it.  Settle with :meth:`confirm` IN DISPATCH ORDER before
        any synchronous verb.  RANGE plans take :meth:`apply`.

        ``donate_store`` is accepted for the JAX signature and changes no
        result (a port pass never writes into its input store); it drops
        the held pre-plan reference, as donation does there.
        """
        n = len(batch)
        if n == 0:
            raise ValueError("apply_nowait requires a non-empty plan")
        codes = np.asarray(batch.codes)
        if bool((codes == OP_RANGE).any()):
            raise ValueError(
                "apply_nowait is CRUD-only; RANGE plans take apply()")
        host = OpBatch(codes, np.asarray(batch.keys),
                       np.asarray(batch.values))
        if pad_to_pow2:
            host = host.pad_to(pow2_width(n))
        store_before = self._store
        self._store, values, ok = self.executor.apply_nowait(
            self._store, host, donate_store=donate_store)
        return PendingPlan(
            batch=host, n_user=n,
            store_before=None if donate_store else store_before,
            store_after=self._store, values=values, ok=ok)

    def confirm(self, pending: PendingPlan) -> Optional[Result]:
        """Settle one :meth:`apply_nowait` dispatch.  On acceptance returns
        the plan's :class:`Result` (sliced back to the caller's
        pre-padding width); on rejection rolls the client back to the
        pre-plan store and returns ``None`` — the caller replays
        ``pending.batch`` (and every later unconfirmed plan) through
        :meth:`apply`, which re-derives the same announce timestamps."""
        if not pending.ok:
            self._store = pending.rollback_store()
            return None
        base = int(pending.store_after.ts) - len(pending.batch)
        dur = self.durability
        if dur is not None:
            # log-on-confirm (the pipelined half of confirm-after-fsync):
            # an ACCEPTED plan is logged here, before its Result exists; a
            # rejected plan is never logged — its replay logs through
            # apply(), so the WAL carries exactly one record per base_ts
            dur.log_plan(base, pending.batch.codes, pending.batch.keys,
                         pending.batch.values)
        values = pending.values.cpu().numpy()[:pending.n_user]
        return make_result(values, pending.batch.codes[:pending.n_user],
                           base, ())

    def lifecycle_tick(self) -> None:
        """Run the policy's proactive grow/maintain triggers now (the
        pipelined front end calls this between plans)."""
        self._store = self.executor.lifecycle_tick(self._store)

    def insert(self, keys, values) -> Result:
        """Batched INSERT; ``Result.values`` holds the previous values."""
        return self.apply(OpBatch.inserts(keys, values))

    def delete(self, keys) -> Result:
        """Batched DELETE (tombstones; physical reclaim via compact())."""
        return self.apply(OpBatch.deletes(keys))

    def search(self, keys) -> Result:
        """Batched SEARCH as announce ops (advances the clock)."""
        return self.apply(OpBatch.searches(keys))

    # ------------------------------------------------------------------ read
    def lookup(self, keys, snap_ts=None, *,
               pad_to_pow2: bool = False) -> np.ndarray:
        """Read-only batched SEARCH at ``snap_ts`` (default: the current
        clock).  Does not advance the clock; KEY_MAX keys return
        NOT_FOUND, the internal pad sentinel KEY_MAX - 1 is rejected."""
        if snap_ts is None:
            snap_ts = self.ts
        keys = np.atleast_1d(np.asarray(keys, np.int32))
        if keys.size and bool(np.any(keys == KEY_MAX - 1)):
            raise ValueError(
                f"lookup key {KEY_MAX - 1} is the internal pad sentinel "
                f"(valid keys are < {KEY_MAX - 1}; KEY_MAX masks out)")
        n = len(keys)
        if pad_to_pow2 and n:
            pad = pow2_width(n) - n
            keys = np.concatenate([keys, np.full(pad, KEY_MAX, np.int32)])
            snap = np.asarray(snap_ts, np.int32)
            if snap.ndim:
                snap_ts = np.concatenate([snap, np.zeros(pad, np.int32)])
        return self.executor.lookup(self._store, keys,
                                    snap_ts).cpu().numpy()[:n]

    def range(self, k1: int, k2: int, snap_ts: Optional[int] = None, *,
              max_results: int = 1024, scan_leaves: int = 16,
              max_rounds: int = 8) -> List[Tuple[int, int]]:
        """[k1, k2] answered completely at one snapshot; ``snap_ts=None``
        registers a fresh snapshot for the scan and releases it."""
        return self.range_all([k1], [k2], snap_ts, max_results=max_results,
                              scan_leaves=scan_leaves,
                              max_rounds=max_rounds)[0]

    def range_all(self, k1s, k2s, snap_ts: Optional[int] = None, *,
                  max_results: int = 1024, scan_leaves: int = 16,
                  max_rounds: int = 8) -> List[List[Tuple[int, int]]]:
        """Q intervals answered completely at one snapshot, one batched
        pass per pagination round shared by all still-truncated queries."""
        opts = RangeOptions(max_results=max_results,
                            scan_leaves=scan_leaves, max_rounds=max_rounds)
        if snap_ts is None:
            with self.snapshot() as ts:
                return self.executor.range_all(self._store, k1s, k2s, ts,
                                               opts)
        return self.executor.range_all(self._store, k1s, k2s, snap_ts, opts)

    def range_page(self, k1s, k2s, snap_ts, *, max_results: int = 1024,
                   scan_leaves: int = 16, max_rounds: int = 8) -> RangePage:
        """ONE bounded pass over Q intervals; resume truncated queries
        from ``page.resume_k1``."""
        return self.executor.range_page(
            self._store, k1s, k2s, snap_ts,
            RangeOptions(max_results=max_results, scan_leaves=scan_leaves,
                         max_rounds=max_rounds))

    def scan_page(self, k1: int, k2: int, snap_ts, *,
                  max_scan_leaves: int = 64,
                  max_results: int = 1024) -> RangePage:
        """The paper's single-interval RANGEQUERY pass over exactly
        ``max_scan_leaves`` chained leaves."""
        return self.executor.scan_page(
            self._store, k1, k2, snap_ts,
            max_scan_leaves=max_scan_leaves, max_results=max_results)

    # --------------------------------------------------------- snapshots, GC
    def acquire_snapshot(self) -> int:
        """Register a snapshot and return its ts; pair with
        :meth:`release_snapshot` (prefer :meth:`snapshot`)."""
        self._store, ts = self.executor.snapshot(self._store)
        return ts

    def release_snapshot(self, snap_ts: int) -> None:
        self._store = self.executor.release(self._store, snap_ts)

    @contextlib.contextmanager
    def snapshot(self) -> Iterator[int]:
        """Registered snapshot as a context manager, released on exit even
        on error (GC never starves)."""
        ts = self.acquire_snapshot()
        try:
            yield ts
        finally:
            self.release_snapshot(ts)

    def compact(self) -> int:
        """Reclaim versions no active snapshot can read and repack leaves
        (stop-the-world); returns the live-key count."""
        self._store, n_live = self.executor.compact(self._store)
        return n_live

    def reindex(self) -> None:
        """Repack the fat-node index at pack_fill occupancy; every result
        is byte-identical before and after."""
        self._store = self.executor.reindex(self._store)

    # ------------------------------------------------------------- lifecycle
    def maintain(self, budget: Optional[int] = None, *,
                 phase: int = 0) -> Tuple[int, int]:
        """ONE bounded incremental maintenance pass: purge tracker-dead
        keys, merge underfull neighbours, reclaim up to ``budget`` retired
        leaf slots.  Returns ``(leaves_reclaimed, pairs_merged)``; results
        at every registered snapshot are unchanged."""
        self._store, reclaimed, merged = self.executor.maintain(
            self._store, budget, phase=phase)
        return reclaimed, merged

    def grow(self, *, leaves: bool = False, versions: bool = False,
             tracker: bool = False) -> None:
        """Double the selected pools now (bit-exact)."""
        self._store = self.executor.grow(
            self._store, leaves=leaves, versions=versions, tracker=tracker)

    # ------------------------------------------------------------ inspection
    def live_items(self) -> List[Tuple[int, int]]:
        """All (key, latest live value) pairs in key order (host-side)."""
        return _store.live_items(self._store)

    def __len__(self) -> int:
        return len(self.live_items())

    def __repr__(self) -> str:
        return (f"Uruv(device={self.executor.device}, ts={self.ts}, "
                f"leaf_cap={self.config.leaf_cap})")
