"""Wait-free combining layer — the announce/help construction, batched.

A port of the JAX package's ``repro.core.batch``: the fast path applies a
whole mixed announce array in one ``store.bulk_apply`` pass; on rejection
the layer helps in rounds — an index repack on ``OFLOW_INDEX``, a
compaction on a full pool, and otherwise halving the announce array and
re-applying at the ORIGINAL per-op timestamps, so the linearization is
bit-identical to the one-pass application.  RANGE ops segment the array
and are answered completely by ``bulk_range_all``.

The port runs under the fixed-footprint policy only (no pool growth):
a store that cannot fit the working set even after compaction raises
:class:`CapacityError`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import store as S
from repro_torch.core.ref import KEY_MAX, KEY_MIN, NOT_FOUND, OP_RANGE


class CapacityError(RuntimeError):
    """The store cannot fit the working set (or a single op violates
    ``leaf_cap``).  Carries ``oflow`` (the ``OFLOW_*`` bits of the last
    rejection), ``occupancy`` (``n_alloc / max_leaves``),
    ``frozen_fraction`` (allocated-but-dead share of the leaf pool) and
    the version pool fill ``n_vers`` / ``max_versions``."""

    def __init__(self, message: str, *, store: Optional[S.UruvStore] = None,
                 oflow: int = 0):
        self.oflow = int(oflow)
        self.occupancy = 0.0
        self.frozen_fraction = 0.0
        self.n_vers = 0
        self.max_versions = 0
        if store is not None:
            n_alloc = int(store.n_alloc)
            self.occupancy = n_alloc / max(int(store.cfg.max_leaves), 1)
            self.frozen_fraction = (n_alloc - int(store.n_leaves)) / max(
                n_alloc, 1)
            self.n_vers = int(store.n_vers)
            self.max_versions = int(store.cfg.max_versions)
            message = (
                f"{message} [oflow={self.oflow:#x} "
                f"occupancy={self.occupancy:.2f} "
                f"frozen_fraction={self.frozen_fraction:.2f} "
                f"versions={self.n_vers}/{self.max_versions}]"
            )
        super().__init__(message)


MAX_SLOWPATH_ROUNDS = 64


def _clear_oflow(store: S.UruvStore) -> S.UruvStore:
    return dataclasses.replace(store, oflow=torch.zeros_like(store.oflow))


def _bump(stats: Optional[Dict[str, int]], key: str, by: int = 1) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + by


def _apply_rounds(
    store: S.UruvStore,
    codes: np.ndarray,
    keys: np.ndarray,
    values: np.ndarray,
    op_ts: Optional[np.ndarray],
    next_ts,
    *,
    light_path: bool = True,
    stats: Optional[Dict[str, int]] = None,
    _depth: int = 0,
) -> Tuple[S.UruvStore, np.ndarray]:
    """One fast-path attempt + bounded help-rounds on rejection.

    ``op_ts is None`` is the common entry: the pass assigns ``store.ts +
    i`` itself.  Slow-path recursion materialises the timestamps once and
    slices them, so every round applies its ops at exactly the timestamps
    the one-pass application would have used.  ``stats`` counts every
    pass and slow-path round.
    """
    if _depth > MAX_SLOWPATH_ROUNDS:
        raise CapacityError("slow path failed to converge; store too small",
                            store=store)
    _bump(stats, "device_passes")
    new_store, res, ok = S.bulk_apply(store, codes, keys, values,
                                      op_ts=op_ts, next_ts=next_ts,
                                      light_path=light_path)
    if ok:
        return new_store, res.cpu().numpy()
    _bump(stats, "slow_path_rounds")
    reason = int(new_store.oflow) & ~int(store.oflow)
    again = dict(light_path=light_path, stats=stats, _depth=_depth + 1)
    if reason & S.OFLOW_INDEX:
        # fat-node pools fragmented (or root overflow): repack, then retry
        # at the SAME timestamps — results unchanged
        _bump(stats, "reindexes")
        return _apply_rounds(S.reindex(_clear_oflow(store)), codes, keys,
                             values, op_ts, next_ts, **again)
    if reason & (S.OFLOW_VERSIONS | S.OFLOW_LEAVES):
        _bump(stats, "compactions")
        compacted, _ = S.compact(_clear_oflow(store))
        # progress check on the constrained resources: the version pool
        # and the leaf bump-allocator (compact() resets both)
        progressed = (int(compacted.n_vers) < int(store.n_vers)
                      or int(compacted.n_alloc) < int(store.n_alloc))
        if not progressed and not (reason & S.OFLOW_LEAFBATCH):
            raise CapacityError(
                f"store full (versions={int(store.n_vers)}/"
                f"{store.cfg.max_versions}, "
                f"leaves={int(store.n_alloc)}/{store.cfg.max_leaves})",
                store=store, oflow=reason,
            )
        return _apply_rounds(compacted, codes, keys, values, op_ts, next_ts,
                             **again)
    # OFLOW_LEAFBATCH: help in rounds — halve the announce array, keeping
    # the per-op timestamps of the rejected one-pass attempt
    if len(keys) == 1:
        raise CapacityError("single op rejected; leaf_cap too small",
                            store=store, oflow=reason)
    if op_ts is None:
        base = int(store.ts)
        op_ts = (base + np.arange(len(keys))).astype(np.int32)
        if next_ts is None:
            next_ts = base + len(keys)
    mid = len(keys) // 2
    st = _clear_oflow(store)
    st, res_a = _apply_rounds(st, codes[:mid], keys[:mid], values[:mid],
                              op_ts[:mid], int(op_ts[mid]), **again)
    st, res_b = _apply_rounds(st, codes[mid:], keys[mid:], values[mid:],
                              op_ts[mid:], next_ts, **again)
    return st, np.concatenate([res_a, res_b])


def apply_mixed(
    store: S.UruvStore,
    codes: np.ndarray,
    keys: np.ndarray,
    values: np.ndarray,
    *,
    light_path: bool = True,
    max_results: int = 1024,
    scan_leaves: int = 16,
    max_rounds: int = 8,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[S.UruvStore, np.ndarray, List[Tuple[int, List[Tuple[int, int]]]]]:
    """Array-level mixed announce sequencer — the host half of the ADT.

    Linearizes ``(codes[i], keys[i], values[i])`` in announce order (op i
    at ts base+i), matching ``RefStore.apply_batch``.  Returns ``(store,
    results[n] int64, range_pages)`` with ``range_pages`` a list of
    (announce_pos, complete (key, value) page) per RANGE op (``results``
    carries their live-key counts).

    A pure-CRUD array is one ``bulk_apply`` pass.  With range ops the
    array runs in segments at range boundaries: each CRUD run is one pass
    at its original announce timestamps, and each run of consecutive
    range ops one batched ``bulk_range`` pass against the store state
    that precedes it, so a range snapshot resolves every key at chain
    depth 0 whatever later updates the batch holds.
    """
    codes = np.asarray(codes, np.int32)
    keys = np.asarray(keys, np.int32)
    vals = np.asarray(values, np.int32)
    n = len(codes)
    if n == 0:
        return store, np.zeros(0, np.int64), []
    rmask = codes == OP_RANGE
    if not rmask.any():
        store, res = _apply_rounds(store, codes, keys, vals, None, None,
                                   light_path=light_path, stats=stats)
        return store, res.astype(np.int64), []
    base = int(store.ts)
    op_ts = (base + np.arange(n)).astype(np.int32)
    results = np.full(n, NOT_FOUND, np.int64)
    range_pages: List[Tuple[int, List[Tuple[int, int]]]] = []
    i = 0
    while i < n:
        j = i
        while j < n and bool(rmask[j]) == bool(rmask[i]):
            j += 1
        if rmask[i]:
            pages = bulk_range_all(
                store, keys[i:j], vals[i:j], op_ts[i:j],
                max_results=max_results, scan_leaves=scan_leaves,
                max_rounds=max_rounds, stats=stats)
            results[i:j] = [len(p) for p in pages]
            range_pages.extend(zip(range(i, j), pages))
            # range passes do not advance the clock: restate it
            store = dataclasses.replace(
                store, ts=torch.tensor(base + j, dtype=torch.int32,
                                       device=store.device))
        else:
            store, res = _apply_rounds(store, codes[i:j], keys[i:j],
                                       vals[i:j], op_ts[i:j], base + j,
                                       light_path=light_path, stats=stats)
            results[i:j] = res
        i = j
    return store, results, range_pages


# ---------------------------------------------------------------------------
# Batched range search sequencing (host side of store.bulk_range)
# ---------------------------------------------------------------------------

# sentinel interval that can never match a key (retired queries re-enter
# the pass as no-ops: lo > every key, k2 < every key => zero work)
_DONE_LO = KEY_MAX
_DONE_HI = KEY_MIN


def bulk_range_all(
    store: S.UruvStore,
    k1s,
    k2s,
    snap_ts,
    *,
    max_results: int = 1024,
    scan_leaves: int = 16,
    max_rounds: int = 8,
    stats: Optional[Dict[str, int]] = None,
) -> List[List[Tuple[int, int]]]:
    """Answer Q range queries COMPLETELY; returns per-query (key, value)
    lists.  One ``bulk_range`` pass answers all Q intervals; only queries
    still truncated re-enter the next pass from their exact ``resume_k1``,
    the active set compacted to power-of-two widths.  Read-only:
    ``snap_ts`` must already be registered if isolation across later
    updates is required."""
    k1 = np.asarray(k1s, np.int32).reshape(-1)
    k2 = np.asarray(k2s, np.int32).reshape(-1)
    Q = len(k1)
    snaps = np.broadcast_to(np.asarray(snap_ts, np.int32), (Q,))
    out: List[List[Tuple[int, int]]] = [[] for _ in range(Q)]
    idx = np.arange(Q)                    # active query -> caller position
    lo, hi, sn = k1.copy(), k2.copy(), snaps.copy()
    for _ in range(MAX_SLOWPATH_ROUNDS * 64):
        W = max(1, 1 << int(len(idx) - 1).bit_length())
        pad = W - len(idx)
        _bump(stats, "device_passes")
        page = S.bulk_range(
            store,
            np.concatenate([lo, np.full(pad, _DONE_LO, np.int32)]),
            np.concatenate([hi, np.full(pad, _DONE_HI, np.int32)]),
            np.concatenate([sn, np.zeros(pad, np.int32)]),
            max_results=max_results, scan_leaves=scan_leaves,
            max_rounds=max_rounds)
        keys, vals, cnt, trunc, resume = (t.cpu().numpy() for t in page)
        trunc = trunc[: len(idx)]
        for a, q in enumerate(idx):
            c = int(cnt[a])
            out[q].extend(zip(keys[a, :c].tolist(), vals[a, :c].tolist()))
        if not trunc.any():
            break
        act = np.nonzero(trunc)[0]
        idx = idx[act]
        lo = resume[act].astype(np.int32)
        hi = hi[act]
        sn = sn[act]
    else:
        raise CapacityError(
            "bulk_range_all failed to converge: "
            f"{len(idx)} queries still truncated after "
            f"{MAX_SLOWPATH_ROUNDS * 64} passes; widen max_results or the "
            "scan_leaves * max_rounds leaf budget")
    return out
