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
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import store as _store
from repro_torch.core.ref import KEY_MAX
from repro_torch.api.executors import (
    LifecyclePolicy, LocalExecutor, RangeOptions,
)
from repro_torch.api.opbatch import (
    OpBatch, RangePage, Result, make_result, pow2_width,
)


class Uruv:
    """Stateful client over an immutable store + a single-device executor.

    Runs on ``device`` (default ``cuda``; raises when CUDA is absent,
    ``device="cpu"`` gives the plain PyTorch path).  The store keeps a
    fixed footprint in the port: ``policy`` must be
    ``LifecyclePolicy(auto_grow=False, auto_maintain=False)`` (the
    default here), and a working set beyond the configured pools raises
    ``CapacityError``.
    """

    def __init__(self, config: Optional[_store.UruvConfig] = None, *,
                 device=None, store=None,
                 policy: Optional[LifecyclePolicy] = None):
        if store is not None:
            config = config or store.cfg
            device = store.device if device is None else device
        self.executor = LocalExecutor(config, device=device, policy=policy)
        self._store = store if store is not None else self.executor.create()

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
        ``compactions``) plus the store's index counters
        ``index_delta_passes`` and ``index_propagations``."""
        s = dict(self.executor.stats)
        s["index_delta_passes"] = int(self._store.index.stat_delta_passes)
        s["index_propagations"] = int(self._store.index.stat_propagations)
        return s

    @property
    def ts(self) -> int:
        """The global clock (the paper's FAA counter)."""
        return self.executor.ts(self._store)

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

    # ------------------------------------------------------------ inspection
    def live_items(self) -> List[Tuple[int, int]]:
        """All (key, latest live value) pairs in key order (host-side)."""
        return _store.live_items(self._store)

    def __len__(self) -> int:
        return len(self.live_items())

    def __repr__(self) -> str:
        return (f"Uruv(device={self.executor.device}, ts={self.ts}, "
                f"leaf_cap={self.config.leaf_cap})")
