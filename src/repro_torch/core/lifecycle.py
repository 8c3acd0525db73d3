"""Store lifecycle — proactive growth + incremental maintenance.

A port of the JAX package's ``repro.core.lifecycle`` (DESIGN.md Sec 10):

  * :func:`grow` doubles the leaf / version / tracker pools to the next
    power of two, extending every pool at its tail, so leaf ids, version
    slots, index node ids and every timestamp stay bit-exact.
  * :func:`maintain` is one bounded incremental pass: it purges keys whose
    head version is a tombstone at or below ``min_active_ts``, merges
    underfull neighbours (the paper's merge/MIN protocol) for at most
    ``budget`` leaf pairs, and relocates at most ``budget`` live leaves
    into dead slots to release the tail of the leaf bump allocator.  Every
    registered snapshot reads the same before and after.
  * :class:`LifecyclePolicy` and the host triggers (:func:`lifecycle_tick`,
    :func:`relieve_pressure`) that ``core.batch`` and the executors wire
    in: grow on ``OFLOW_LEAVES`` / ``OFLOW_VERSIONS`` instead of raising,
    and interleave maintenance on a frozen-fraction trigger.

Every entry point returns a new store and writes nothing into its input
(older stores stay valid snapshots).  A stacked store (every array with
a leading [n_shards] axis, ``repro_torch.core.sharded``) is handled
shard by shard as the JAX package's ``vmap`` does: every shard grows and
maintains in the same call, so shard shapes stay equal, and the
counters the triggers read are summed (or, for the grow trigger, the
largest shard's) in one host read.  A member's block of a store sharded
one shard a process holds only its own shard: the readers then take
``gather`` (the executor's ``all_gather`` over its group), and the
counters are summed or maximised over every member in that read, so
every member takes the same grow, maintain, compact and reindex
decision from the numbers the stacked store reads.  Where the reference
scatters with ``mode="drop"``, the port aims the dropped writes at a
sink slot (``repro_torch.core._ops``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import _ops as O
from repro_torch.core import index as I
from repro_torch.core import store as S
from repro_torch.core.ref import KEY_MAX, TOMBSTONE

I32 = torch.int32


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LifecyclePolicy:
    """Host-side lifecycle policy (DESIGN.md Sec 10).

    The defaults make the store self-sizing: capacity rejections grow the
    rejected pool and retry, and maintenance runs incrementally whenever
    the dead fraction of the allocated leaf pool crosses
    ``frozen_trigger``.  ``auto_grow=False, auto_maintain=False`` is the
    fixed footprint (compact-then-``CapacityError``).
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


DEFAULT_POLICY = LifecyclePolicy()


def across(x: torch.Tensor, gather=None) -> torch.Tensor:
    """This store's partial counters ``x`` ([k]: sums or maxima over its
    shards) as ``[members, k]``: one row, or with ``gather`` (a function
    stacking every member's ``x``) one row a member of the group, to be
    summed or maximised along dim 0."""
    return x[None] if gather is None else gather(x)


# ---------------------------------------------------------------------------
# grow — pool doubling (pow2 buckets)
# ---------------------------------------------------------------------------

def next_pool_size(n: int) -> int:
    """The next power-of-two bucket strictly above ``n`` (2n when n is a
    power of two)."""
    return 1 << int(n).bit_length()


def _pad_dim0(x: torch.Tensor, size: int, fill) -> torch.Tensor:
    """``x`` extended along dim 0 to ``size`` with ``fill``."""
    old = x.shape[0]
    if size == old:
        return x
    return torch.cat([x, torch.full((size - old,) + tuple(x.shape[1:]),
                                    fill, dtype=x.dtype, device=x.device)])


def _grow(store: S.UruvStore, *, new_ml: int, new_mv: int,
          new_mt: int) -> S.UruvStore:
    if S.is_stacked(store):        # the pools pad behind the shard axis
        return S.stack_shards([
            _grow(v, new_ml=new_ml, new_mv=new_mv, new_mt=new_mt)
            for v in S.shard_views(store)])
    cfg = store.cfg
    new_cfg = dataclasses.replace(cfg, max_leaves=new_ml,
                                  max_versions=new_mv, tracker_cap=new_mt)
    return dataclasses.replace(
        store,
        leaf_keys=_pad_dim0(store.leaf_keys, new_ml, KEY_MAX),
        leaf_vhead=_pad_dim0(store.leaf_vhead, new_ml, -1),
        leaf_count=_pad_dim0(store.leaf_count, new_ml, 0),
        leaf_next=_pad_dim0(store.leaf_next, new_ml, -1),
        leaf_newnext=_pad_dim0(store.leaf_newnext, new_ml, -1),
        leaf_frozen=_pad_dim0(store.leaf_frozen, new_ml, False),
        leaf_ts=_pad_dim0(store.leaf_ts, new_ml, 0),
        index=I.grow_to(store.index,
                        I.index_config(new_ml, cfg.index_fanout), new_ml),
        ver_value=_pad_dim0(store.ver_value, new_mv, 0),
        ver_ts=_pad_dim0(store.ver_ts, new_mv, 0),
        ver_next=_pad_dim0(store.ver_next, new_mv, -1),
        trk_ts=_pad_dim0(store.trk_ts, new_mt, 0),
        trk_active=_pad_dim0(store.trk_active, new_mt, False),
        cfg=new_cfg,
    )


@tracing.spanned("lifecycle.grow")
def grow(store: S.UruvStore, *, leaves: bool = False, versions: bool = False,
         tracker: bool = False) -> S.UruvStore:
    """Double the selected pools; everything else is bit-exact.

    Capacities move to the next power-of-two bucket (``next_pool_size``).
    Leaf ids, version slots, index node ids/ordinals and every timestamp
    are preserved: the pools extend at the tail (growing the leaf pool
    tail-extends every index level and stacks fresh root levels when the
    depth model deepens).
    """
    if not (leaves or versions or tracker):
        raise ValueError("grow(): select at least one pool "
                         "(leaves=, versions=, tracker=)")
    cfg = store.cfg
    return _grow(
        store,
        new_ml=next_pool_size(cfg.max_leaves) if leaves else cfg.max_leaves,
        new_mv=(next_pool_size(cfg.max_versions) if versions
                else cfg.max_versions),
        new_mt=next_pool_size(cfg.tracker_cap) if tracker
        else cfg.tracker_cap,
    )


# ---------------------------------------------------------------------------
# maintain — bounded incremental reclamation + merge (paper's MIN protocol)
# ---------------------------------------------------------------------------

def _maintain(store: S.UruvStore, phase: int, budget: int):
    cfg = store.cfg
    ML, L = cfg.max_leaves, cfg.leaf_cap
    B = budget
    dev = store.device
    floor = S.min_active_ts(store)
    allpos = O.arange32(ML, dev)

    # ---- dead-at-floor mask (tracker-gated, the retention rule of
    # compact): a slot is dead iff its head version is a tombstone at or
    # below the floor
    vh = store.leaf_vhead
    vhc = vh.clamp_min(0)
    occupied = O.arange32(L, dev)[None, :] < store.leaf_count[:, None]
    dead_slot = (occupied & (vh >= 0)
                 & (store.ver_value[vhc] == TOMBSTONE)
                 & (store.ver_ts[vhc] <= floor))
    live_slot = occupied & ~dead_slot
    live_cnt = live_slot.sum(1, dtype=I32)                     # [ML]

    # ---- pair selection: adjacent leaf ordinals (p, p+1), p = phase mod
    # 2; eligible when the pair has purgeable keys or merging fits one
    # leaf with a member under MIN; the first `budget` are rewritten
    NP = ML // 2
    pos = phase + 2 * O.arange32(NP, dev)                      # left ordinal
    valid = (pos + 1) < store.n_leaves
    nl1 = (store.n_leaves - 1).clamp_min(0)
    la = torch.where(valid, I.leaf_at(store.index, torch.minimum(pos, nl1)),
                     0)
    lb = torch.where(valid, I.leaf_at(store.index,
                                      torch.minimum(pos + 1, nl1)), 0)
    live_a, live_b = live_cnt[la], live_cnt[lb]
    mergeable = valid & (live_a + live_b <= L) & (
        (live_a < cfg.min_fill) | (live_b < cfg.min_fill)
        | (live_a + live_b <= L // 2)
    ) & I.merge_deletable(store.index, torch.minimum(pos + 1, nl1))
    has_dead = valid & ((live_a < store.leaf_count[la])
                        | (live_b < store.leaf_count[lb]))
    eligible = mergeable | has_dead
    rank = O.cumsum32(eligible.to(I32)) - 1
    sel = O.lin_1d(torch.where(eligible & (rank < B), rank, B), B)

    def pick(vals, fill, dtype=I32):
        return O.drop_set(torch.full((B,), fill, dtype=dtype, device=dev),
                          sel, vals)

    pair_pos = pick(pos, ML)
    pair_a = pick(la, 0)
    pair_b = pick(lb, 0)
    pair_merge = pick(mergeable, False, torch.bool)
    pair_real = pair_pos < ML

    # ---- rewrite the selected pairs: purge dead keys; merge when the
    # union fits (right leaf cleared + frozen = retired garbage)
    pa, pb = pair_a.long(), pair_b.long()
    keys_a = torch.where(live_slot[pa], store.leaf_keys[pa], KEY_MAX)
    vh_a = torch.where(live_slot[pa], store.leaf_vhead[pa], -1)
    keys_b = torch.where(live_slot[pb], store.leaf_keys[pb], KEY_MAX)
    vh_b = torch.where(live_slot[pb], store.leaf_vhead[pb], -1)
    mk, mv_ = O.sort_rows(torch.cat([keys_a, keys_b], 1),
                          torch.cat([vh_a, vh_b], 1))          # [B, 2L]
    pk_a, pv_a = O.sort_rows(keys_a, vh_a)
    pk_b, pv_b = O.sort_rows(keys_b, vh_b)
    la_live, lb_live = live_cnt[pa], live_cnt[pb]
    merge = pair_real & pair_merge
    mcol = merge[:, None]
    out_a_keys = torch.where(mcol, mk[:, :L], pk_a)
    out_a_vh = torch.where(mcol, mv_[:, :L], pv_a)
    out_a_cnt = torch.where(merge, la_live + lb_live, la_live)
    out_b_keys = torch.where(mcol, KEY_MAX, pk_b)
    out_b_vh = torch.where(mcol, -1, pv_b)
    out_b_cnt = torch.where(merge, 0, lb_live)

    wa = torch.where(pair_real, pair_a, ML)
    wb = torch.where(pair_real, pair_b, ML)
    leaf_keys = O.sinked(store.leaf_keys)
    leaf_vhead = O.sinked(store.leaf_vhead)
    leaf_count = O.sinked(store.leaf_count)
    O.put(leaf_keys, O.lin_rows(wa, ML, L), out_a_keys)
    O.put(leaf_vhead, O.lin_rows(wa, ML, L), out_a_vh)
    O.put(leaf_count, O.lin_1d(wa, ML), out_a_cnt)
    O.put(leaf_keys, O.lin_rows(wb, ML, L), out_b_keys)
    O.put(leaf_vhead, O.lin_rows(wb, ML, L), out_b_vh)
    O.put(leaf_count, O.lin_1d(wb, ML), out_b_cnt)
    leaf_frozen = O.drop_set(store.leaf_frozen,
                             O.lin_1d(torch.where(merge, pair_b, ML), ML),
                             True)
    n_merged = merge.sum(dtype=I32)

    # ---- index delta: delete the right members' separators (bounded);
    # the left member keeps its separator
    index1 = I.apply_merge_delta(store.index, (pair_pos + 1).clamp_max(ML - 1),
                                 pair_b, merge)
    n_leaves1 = store.n_leaves - n_merged
    # chain splice: the left member inherits the merged-away successor
    leaf_next = O.drop_set(store.leaf_next,
                           O.lin_1d(torch.where(merge, pair_a, ML), ML),
                           store.leaf_next[pb])

    # ---- bounded relocation: move up to `budget` of the highest live
    # leaves into the lowest dead slots, then release the all-dead tail
    ref = index1.leaf_ent >= 0              # referenced by the index
    alloc = allpos < store.n_alloc
    dead = alloc & ~ref
    drank = O.cumsum32(dead.to(I32)) - 1
    dst = O.drop_set(torch.full((B,), ML, dtype=I32, device=dev),
                     O.lin_1d(torch.where(dead & (drank < B), drank, B), B),
                     allpos)
    rrank = O.cumsum32(ref.flip(0).to(I32)).flip(0) - 1      # from the top
    src = O.drop_set(torch.full((B,), -1, dtype=I32, device=dev),
                     O.lin_1d(torch.where(ref & (rrank < B), rrank, B), B),
                     allpos)
    do = (dst < ML) & (src >= 0) & (src > dst)
    srcc = torch.where(do, src, 0).long()
    dstc = torch.where(do, dst, ML)
    lk = O.unsink(leaf_keys, (ML, L))
    lv = O.unsink(leaf_vhead, (ML, L))
    lc = O.unsink(leaf_count, (ML,))
    leaf_keys = O.drop_set(lk, O.lin_rows(dstc, ML, L), lk[srcc])
    leaf_vhead = O.drop_set(lv, O.lin_rows(dstc, ML, L), lv[srcc])
    leaf_count = O.drop_set(lc, O.lin_1d(dstc, ML), lc[srcc])
    leaf_ts = O.drop_set(store.leaf_ts, O.lin_1d(dstc, ML),
                         store.leaf_ts[srcc])
    leaf_frozen = O.drop_set(leaf_frozen, O.lin_1d(dstc, ML), False)
    leaf_newnext = O.drop_set(store.leaf_newnext, O.lin_1d(dstc, ML), -1)

    # chain fixups for the moved leaves: the copied next pointer and the
    # predecessor's link follow the relocation map
    remap = O.drop_set(allpos, O.lin_1d(torch.where(do, src, ML), ML),
                       torch.where(do, dst, 0))
    nxt_src = leaf_next[srcc]
    leaf_next = O.drop_set(
        leaf_next, O.lin_1d(dstc, ML),
        torch.where(nxt_src >= 0, remap[nxt_src.clamp_min(0).long()], -1))
    Fi = cfg.index_fanout
    ent = index1.leaf_ent[srcc]
    ordv = I.leaf_ordinal(index1, ent.clamp_min(0) // Fi,
                          ent.clamp_min(0) % Fi)
    has_pred = do & (ordv > 0)
    pred = I.leaf_at(index1, (ordv - 1).clamp_min(0))
    leaf_next = O.drop_set(
        leaf_next,
        O.lin_1d(torch.where(has_pred, remap[pred.clamp_min(0).long()], ML),
                 ML),
        torch.where(do, dst, -1))

    # index entry retarget (reverse-map lookup; O(budget))
    index2 = I.retarget_leaves(index1, src, dst, do)
    ref2 = index2.leaf_ent >= 0
    n_alloc = torch.where(ref2, allpos + 1, 0).max().clamp_min(1).to(I32)

    # freed tail: scrub so the bump allocator can hand the slots out again
    freed = alloc & (allpos >= n_alloc)
    fcol = freed[:, None]
    new = dataclasses.replace(
        store,
        leaf_keys=torch.where(fcol, KEY_MAX, leaf_keys),
        leaf_vhead=torch.where(fcol, -1, leaf_vhead),
        leaf_count=torch.where(freed, 0, leaf_count),
        leaf_next=torch.where(freed, -1, leaf_next),
        leaf_newnext=torch.where(freed, -1, leaf_newnext),
        leaf_frozen=torch.where(freed, False, leaf_frozen),
        leaf_ts=torch.where(freed, 0, leaf_ts),
        n_alloc=n_alloc,
        index=index2,
        n_leaves=n_leaves1,
    )
    return new, store.n_alloc - n_alloc, n_merged


@tracing.spanned("lifecycle.maintain")
def maintain(store: S.UruvStore, budget: int = 128, *, phase: int = 0,
             gather=None) -> Tuple[S.UruvStore, int, int]:
    """ONE bounded incremental maintenance pass.

    Rewrites at most ``budget`` adjacent leaf pairs — purging keys whose
    head version is a tombstone at or below ``min_active_ts`` and merging
    neighbours whose live keys fit one leaf with a member under MIN —
    then relocates at most ``budget`` live leaves downward to release the
    dead tail of the leaf allocator.  Returns ``(store,
    leaves_reclaimed, pairs_merged)``.  The clock, the version pool and
    the tracker are untouched: every result, reads at any registered
    snapshot included, is the same before and after.  Alternate ``phase``
    (0/1) between calls to cover both pair parities.  A stacked store
    maintains every shard and returns the summed counts (summed over the
    group too, with ``gather``).
    """
    if not S.is_stacked(store):
        new, reclaimed, merged = _maintain(store, phase % 2, budget)
        sums = torch.stack([reclaimed, merged])
        with tracing.host_read("lifecycle.maintain"):
            reclaimed, merged = sums.tolist()
        return new, reclaimed, merged
    outs = [_maintain(v, phase % 2, budget) for v in S.shard_views(store)]
    new = S.stack_shards([o[0] for o in outs], base=store)
    sums = across(torch.stack(
        [torch.stack([o[1] for o in outs]).sum(),
         torch.stack([o[2] for o in outs]).sum()]), gather).sum(0)
    with tracing.host_read("lifecycle.maintain"):
        reclaimed, merged = sums.tolist()
    return new, reclaimed, merged


# ---------------------------------------------------------------------------
# Per-pool dirty watermarks (for delta checkpoints)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PoolWatermarks:
    """Host snapshot of the pool allocators at one clock value: between
    two saves with no compaction, version slots below the older
    ``n_vers`` are immutable, so a delta checkpoint is the tail slice."""

    ts: int
    n_alloc: int
    n_vers: int
    n_leaves: int
    max_leaves: int
    max_versions: int
    tracker_cap: int
    compactions: int = 0


def pool_watermarks(store: S.UruvStore, *,
                    compactions: int = 0) -> PoolWatermarks:
    """Read the allocator watermarks (one host transfer; a stacked store
    reports per-shard maxima, and :func:`version_tail_start` then turns
    the tail fast path off).  A group's save gathers its members' blocks
    into the stacked store before it reads them."""
    ts, n_alloc, n_vers, n_leaves = torch.stack(
        [store.ts, store.n_alloc, store.n_vers, store.n_leaves]
    ).reshape(4, -1).amax(1).tolist()
    return PoolWatermarks(
        ts=ts, n_alloc=n_alloc, n_vers=n_vers, n_leaves=n_leaves,
        max_leaves=int(store.cfg.max_leaves),
        max_versions=int(store.cfg.max_versions),
        tracker_cap=int(store.cfg.tracker_cap),
        compactions=compactions)


def version_tail_start(before: PoolWatermarks, store: S.UruvStore, *,
                       compactions: int = 0) -> Optional[int]:
    """The first version slot that may differ from the state ``before``
    describes, or ``None`` when tail stability cannot be guaranteed (a
    compaction ran, the pool is stacked, or the allocator moved
    backwards)."""
    if compactions != before.compactions:
        return None
    if S.is_stacked(store):            # per-shard allocators
        return None
    if int(store.n_vers) < before.n_vers:
        return None
    return before.n_vers


# ---------------------------------------------------------------------------
# Host-side occupancy accounting + triggers
# ---------------------------------------------------------------------------

def leaf_accounting(store: S.UruvStore) -> Dict[str, int]:
    """Bump-allocator accounting: every allocated slot is live (referenced
    by the index) or dead (frozen): ``n_alloc == live + dead``.  A
    stacked store sums its shards."""
    alloc_mask = (torch.arange(store.leaf_frozen.shape[-1],
                               device=store.device)
                  < store.n_alloc.unsqueeze(-1))
    n_alloc, live, dead = torch.stack(
        [store.n_alloc.sum(), store.n_leaves.sum(),
         (store.leaf_frozen & alloc_mask).sum()]).tolist()
    return {
        "n_alloc": n_alloc,
        "live": live,
        "dead": dead,
        "capacity": int(store.cfg.max_leaves) * store.ts.numel(),
    }


def live_key_count(store: S.UruvStore, gather=None) -> int:
    """Keys held by index-referenced leaves (tombstoned keys count until
    maintenance purges them): a pool-occupancy figure."""
    ref = store.index.leaf_ent >= 0
    with tracing.host_read("lifecycle.live_keys", 2):
        return int(across(store.leaf_count[ref].sum().reshape(1),
                          gather).sum())


def dead_fraction(store: S.UruvStore, gather=None) -> float:
    """Dead (unreferenced-but-allocated) fraction of the leaf pool."""
    sums = across(torch.stack([store.n_alloc.sum(), store.n_leaves.sum()]),
                  gather).sum(0)
    with tracing.host_read("lifecycle.dead_fraction"):
        n_alloc, live = sums.tolist()
    return (n_alloc - live) / max(n_alloc, 1)


def run_maintenance(store: S.UruvStore, policy: LifecyclePolicy, *,
                    stats: Optional[Dict[str, int]] = None,
                    max_passes: Optional[int] = None,
                    gather=None) -> S.UruvStore:
    """Bounded burst of maintain passes with alternating phase: stops
    after ``max_passes`` (default ``policy.maintain_passes``), when a pass
    reclaims and merges nothing, or when the dead fraction falls under
    half the trigger."""
    passes = max_passes if max_passes is not None else policy.maintain_passes
    for p in range(passes):
        store, reclaimed, merged = maintain(store, policy.maintain_budget,
                                            phase=p % 2, gather=gather)
        if stats is not None:
            stats["maintain_passes"] = stats.get("maintain_passes", 0) + 1
            stats["leaves_reclaimed"] = (stats.get("leaves_reclaimed", 0)
                                         + reclaimed)
        if reclaimed == 0 and merged == 0:
            break
        if dead_fraction(store, gather) < policy.frozen_trigger / 2:
            break
    return store


@tracing.spanned("lifecycle.tick")
def lifecycle_tick(store: S.UruvStore, policy: LifecyclePolicy, *,
                   stats: Optional[Dict[str, int]] = None,
                   grow_fn=None, gather=None) -> S.UruvStore:
    """The post-apply interleave: a bounded maintain burst on the
    frozen-fraction trigger first, then proactive growth re-checked on
    the maintained store.  ``grow_fn(store)`` lets an executor wrap its
    own growth (and count it).  The maintain trigger reads the pools'
    sums, the grow trigger the fullest shard's allocator (over the group
    too, with ``gather``)."""
    if not (policy.auto_grow or policy.auto_maintain):
        return store
    parts = across(torch.stack([store.n_alloc.sum(), store.n_leaves.sum(),
                                store.n_alloc.max().long()]), gather)
    row = torch.cat([parts[:, :2].sum(0), parts[:, 2:].amax(0)])
    with tracing.host_read("lifecycle.tick"):
        n_alloc, n_leaves, alloc_max = row.tolist()
    dead = n_alloc - n_leaves
    if (policy.auto_maintain and dead >= policy.min_dead_leaves
            and dead / max(n_alloc, 1) >= policy.frozen_trigger):
        store = run_maintenance(store, policy, stats=stats, gather=gather)
        top = across(store.n_alloc.max().reshape(1), gather).max()
        with tracing.host_read("lifecycle.tick"):
            alloc_max = int(top)
    if (policy.auto_grow
            and alloc_max > policy.grow_occupancy * store.cfg.max_leaves):
        if grow_fn is None:
            if stats is not None:
                stats["grows"] = stats.get("grows", 0) + 1
            store = grow(store, leaves=True)
        else:
            store = grow_fn(store)
    return store


@tracing.spanned("lifecycle.relieve")
def relieve_pressure(store: S.UruvStore, reason: int, width: int,
                     policy: LifecyclePolicy, *,
                     stats: Optional[Dict[str, int]] = None,
                     gather=None) -> S.UruvStore:
    """One pressure-relief step for a capacity-rejected batch.

    ``OFLOW_LEAVES``: burst ``maintain`` when the dead fraction is above
    the trigger; otherwise, or if the burst freed nothing, double the leaf
    pool.  ``OFLOW_VERSIONS``: ``compact()`` first when the pool is mostly
    reclaimable, then double the version pool until the batch fits.
    ``OFLOW_INDEX``: repack the index.  Every step strictly increases free
    capacity, so the caller's retry loop converges.  Over a group,
    ``reason`` is every member's bits and ``gather`` reduces the counters.
    """
    if reason & S.OFLOW_INDEX:
        if stats is not None:
            stats["reindexes"] = stats.get("reindexes", 0) + 1
        store = S.reindex(store)
    if reason & S.OFLOW_LEAVES:
        def allocated(st):
            n = across(st.n_alloc.sum().reshape(1), gather).sum()
            with tracing.host_read("lifecycle.relieve"):
                return int(n)

        before = allocated(store)
        if dead_fraction(store, gather) >= policy.frozen_trigger:
            store = run_maintenance(store, policy, stats=stats,
                                    max_passes=policy.pressure_passes,
                                    gather=gather)
        if allocated(store) >= before:
            store = grow(store, leaves=True)
            if stats is not None:
                stats["grows"] = stats.get("grows", 0) + 1
    if reason & S.OFLOW_VERSIONS:
        cfg = store.cfg
        parts = across(torch.stack([store.n_vers.max().long(),
                                    store.n_vers.sum()]), gather)
        top, total = parts[:, 0].max(), parts[:, 1].sum()
        with tracing.host_read("lifecycle.relieve", 2):
            n_vers, n_vers_sum = int(top), int(total)
        # compact() can reclaim at most sum(n_vers) - live_keys versions
        # (every surviving key keeps >= 1): skip it when that cannot fit
        # the batch
        reclaimable_bound = n_vers_sum - live_key_count(store, gather)
        if (reclaimable_bound >= width
                and n_vers >= policy.version_gc_fraction * cfg.max_versions):
            if stats is not None:
                stats["compactions"] = stats.get("compactions", 0) + 1
            store, _ = S.compact(store)
            top = across(store.n_vers.max().reshape(1), gather).max()
            with tracing.host_read("lifecycle.relieve"):
                n_vers = int(top)
        while n_vers + width > store.cfg.max_versions:
            store = grow(store, versions=True)
            if stats is not None:
                stats["grows"] = stats.get("grows", 0) + 1
    return store
