"""Wait-free combining layer — the announce/help construction, batched.

A port of the JAX package's ``repro.core.batch``: the fast path applies a
whole mixed announce array in one ``store.bulk_apply`` pass; on rejection
the layer helps in rounds — an index repack on ``OFLOW_INDEX``, a
compaction on a full pool, and otherwise halving the announce array and
re-applying at the ORIGINAL per-op timestamps, so the linearization is
bit-identical to the one-pass application.  RANGE ops segment the array
and are answered completely by ``bulk_range_all``.

Capacity pressure follows the lifecycle policy: under a self-sizing
policy (``auto_grow``, the client's default) a full pool is relieved by
``lifecycle.relieve_pressure`` (maintenance, pool doubling or a gated
compaction) and the pass retried; with ``policy=None`` or
``auto_grow=False`` a store that cannot fit the working set even after
compaction raises :class:`CapacityError`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import lifecycle as LC
from repro_torch.core import store as S
from repro_torch.core.ref import KEY_MAX, KEY_MIN, NOT_FOUND, OP_RANGE


class CapacityError(RuntimeError):
    """The store cannot fit the working set (or a single op violates
    ``leaf_cap``).  Carries ``oflow`` (the ``OFLOW_*`` bits of the last
    rejection), ``occupancy`` (``n_alloc / max_leaves``),
    ``frozen_fraction`` (allocated-but-dead share of the leaf pool) and
    the version pool fill ``n_vers`` / ``max_versions``.  Over a process
    group (``gather``, as ``lifecycle.across`` takes it; every member
    raises together) these are the whole store's, as a stacked store's
    are."""

    def __init__(self, message: str, *, store: Optional[S.UruvStore] = None,
                 oflow: int = 0, gather=None):
        self.oflow = int(oflow)
        self.occupancy = 0.0
        self.frozen_fraction = 0.0
        self.n_vers = 0
        self.max_versions = 0
        if store is not None:
            # a stacked (sharded) store sums its shards' leaf pools and
            # reports its fullest version pool; a member of a group reads
            # its partial counters across the group
            rows = LC.across(torch.stack([
                store.n_alloc.sum(), store.n_leaves.sum(),
                store.n_vers.max().long(),
                torch.tensor(store.ts.numel(), device=store.ts.device)]),
                gather)
            with tracing.host_read("batch.capacity_error", 2):
                n_alloc, live, n_shards = (
                    int(x) for x in rows[:, [0, 1, 3]].sum(0).tolist())
                n_vers = int(rows[:, 2].max())
            self.occupancy = n_alloc / max(
                int(store.cfg.max_leaves) * n_shards, 1)
            self.frozen_fraction = (n_alloc - live) / max(n_alloc, 1)
            self.n_vers = n_vers
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


@tracing.spanned("batch.round")
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
    policy: Optional[LC.LifecyclePolicy] = None,
    _depth: int = 0,
) -> Tuple[S.UruvStore, np.ndarray]:
    """One fast-path attempt + bounded help-rounds on rejection.

    ``op_ts is None`` is the common entry: the pass assigns ``store.ts +
    i`` itself.  Slow-path recursion materialises the timestamps once and
    slices them, so every round applies its ops at exactly the timestamps
    the one-pass application would have used.  ``stats`` counts every
    pass and slow-path round.

    Capacity policy: with a ``policy`` whose ``auto_grow`` is set,
    ``OFLOW_LEAVES`` / ``OFLOW_VERSIONS`` rejections run one
    ``lifecycle.relieve_pressure`` step and retry at the same timestamps;
    ``policy=None`` keeps the fixed footprint (compact-then-retry, error
    when compaction frees nothing).  Lifecycle choices never change
    results or timestamps, only where the arrays live.
    """
    if _depth > MAX_SLOWPATH_ROUNDS:
        raise CapacityError("slow path failed to converge; store too small",
                            store=store)
    _bump(stats, "device_passes")
    new_store, res, ok = S.bulk_apply(store, codes, keys, values,
                                      op_ts=op_ts, next_ts=next_ts,
                                      light_path=light_path)
    if ok:
        with tracing.host_read("batch.results"):
            return new_store, res.cpu().numpy()
    _bump(stats, "slow_path_rounds")
    with tracing.host_read("batch.reason", 2):
        reason = int(new_store.oflow) & ~int(store.oflow)
    again = dict(light_path=light_path, stats=stats, policy=policy,
                 _depth=_depth + 1)
    if reason & S.OFLOW_INDEX:
        # fat-node pools fragmented (or root overflow): repack, then retry
        # at the SAME timestamps — results unchanged
        _bump(stats, "reindexes")
        return _apply_rounds(S.reindex(_clear_oflow(store)), codes, keys,
                             values, op_ts, next_ts, **again)
    if reason & (S.OFLOW_VERSIONS | S.OFLOW_LEAVES):
        if policy is not None and policy.auto_grow:
            relieved = LC.relieve_pressure(_clear_oflow(store), reason,
                                           len(keys), policy, stats=stats)
            return _apply_rounds(relieved, codes, keys, values, op_ts,
                                 next_ts, **again)
        _bump(stats, "compactions")
        compacted, _ = S.compact(_clear_oflow(store))
        # progress check on the constrained resources: the version pool
        # and the leaf bump-allocator (compact() resets both)
        with tracing.host_read("batch.progress", 2):
            progressed = int(compacted.n_vers) < int(store.n_vers)
        if not progressed:
            with tracing.host_read("batch.progress", 2):
                progressed = int(compacted.n_alloc) < int(store.n_alloc)
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
        with tracing.host_read("batch.clock"):
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


@tracing.spanned("batch.apply_mixed")
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
    policy: Optional[LC.LifecyclePolicy] = None,
    crud_fn=None,
    range_all_fn=None,
    get_ts_fn=None,
    set_ts_fn=None,
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

    The four hooks let another topology reuse THIS loop (one copy of the
    segmentation semantics, as ``bulk_range_all``'s ``page_fn``):
    ``crud_fn(store, codes, keys, values, op_ts, next_ts)`` applies one
    CRUD segment (default: the local help-rounds; a custom fn may ignore
    ``op_ts`` if its passes derive timestamps from the store clock),
    ``range_all_fn(store, k1, k2, snaps)`` answers one RANGE segment
    completely, ``get_ts_fn(store)`` reads the global clock and
    ``set_ts_fn(store, ts)`` restates it after a RANGE segment (range ops
    take announce slots but their passes do not advance the clock).
    """
    codes = np.asarray(codes, np.int32)
    keys = np.asarray(keys, np.int32)
    vals = np.asarray(values, np.int32)
    if crud_fn is None:
        def crud_fn(st, c, k, v, op_ts, next_ts):
            return _apply_rounds(st, c, k, v, op_ts, next_ts,
                                 light_path=light_path, stats=stats,
                                 policy=policy)
    if range_all_fn is None:
        def range_all_fn(st, k1, k2, snaps):
            return bulk_range_all(
                st, k1, k2, snaps, max_results=max_results,
                scan_leaves=scan_leaves, max_rounds=max_rounds, stats=stats)
    if get_ts_fn is None:
        def get_ts_fn(st):
            with tracing.host_read("batch.clock"):
                return int(st.ts)
    if set_ts_fn is None:
        def set_ts_fn(st, ts):
            return dataclasses.replace(
                st, ts=torch.tensor(ts, dtype=torch.int32, device=st.device))
    n = len(codes)
    if n == 0:
        return store, np.zeros(0, np.int64), []
    rmask = codes == OP_RANGE
    if not rmask.any():
        store, res = crud_fn(store, codes, keys, vals, None, None)
        return store, np.asarray(res).astype(np.int64), []
    base = get_ts_fn(store)
    op_ts = (base + np.arange(n)).astype(np.int32)
    results = np.full(n, NOT_FOUND, np.int64)
    range_pages: List[Tuple[int, List[Tuple[int, int]]]] = []
    i = 0
    while i < n:
        j = i
        while j < n and bool(rmask[j]) == bool(rmask[i]):
            j += 1
        if rmask[i]:
            pages = range_all_fn(store, keys[i:j], vals[i:j], op_ts[i:j])
            results[i:j] = [len(p) for p in pages]
            range_pages.extend(zip(range(i, j), pages))
            # CRUD passes advance the clock themselves (next_ts, or the
            # replicated counter); range segments must restate it
            store = set_ts_fn(store, base + j)
        else:
            store, res = crud_fn(store, codes[i:j], keys[i:j], vals[i:j],
                                 op_ts[i:j], base + j)
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


@tracing.spanned("batch.range_all")
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
    page_fn=None,
) -> List[List[Tuple[int, int]]]:
    """Answer Q range queries COMPLETELY; returns per-query (key, value)
    lists.  One ``bulk_range`` pass answers all Q intervals; only queries
    still truncated re-enter the next pass from their exact ``resume_k1``,
    the active set compacted to power-of-two widths.  Read-only:
    ``snap_ts`` must already be registered if isolation across later
    updates is required.

    ``page_fn(store, k1[W], k2[W], snap[W]) -> (keys, vals, count,
    truncated, resume_k1)`` replaces the bounded pass itself (the sharded
    executor supplies its merged pass); the pagination loop is shared
    either way, so the topologies cannot drift."""
    if page_fn is None:
        def page_fn(st, lo_p, hi_p, sn_p):
            _bump(stats, "device_passes")
            return S.bulk_range(st, lo_p, hi_p, sn_p,
                                max_results=max_results,
                                scan_leaves=scan_leaves,
                                max_rounds=max_rounds)
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
        page = page_fn(store,
                       np.concatenate([lo, np.full(pad, _DONE_LO, np.int32)]),
                       np.concatenate([hi, np.full(pad, _DONE_HI, np.int32)]),
                       np.concatenate([sn, np.zeros(pad, np.int32)]))
        with tracing.host_read("batch.range_page", len(page)):
            keys, vals, cnt, trunc, resume = [t.cpu().numpy() for t in page]
        trunc = trunc[: len(idx)]
        with tracing.span("pages"):
            for a, q in enumerate(idx):
                c = int(cnt[a])
                out[q].extend(zip(keys[a, :c].tolist(),
                                  vals[a, :c].tolist()))
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
