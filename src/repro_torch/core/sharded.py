"""Key-range-sharded Uruv: one store per shard.

A port of the JAX package's ``repro.core.sharded``.  The key space is
range-partitioned into ``n_shards`` spans, shard ``s`` owning the keys of
span ``s``.  A mesh (``repro_torch.launch.mesh``) places the shards in
one of two ways:

  * **stacked** (``mesh.group`` None): ONE store whose every array
    carries a leading [n_shards] axis, every shard on the mesh's one
    device.  The reference's collectives become tensor operations along
    the shard axis: ``psum`` a sum (a select: exactly one shard owns an
    op), ``all_gather`` the stack of the shards' outputs, ``all_to_all``
    the transpose of the [src, dst, cap] staging, ``axis_index`` the
    shard's index.  On the card the store kernels run once per shard per
    pass.
  * **one shard a process** (``mesh.group`` a ``torch.distributed``
    process group of ``n_shards`` members): member ``r`` holds shard
    ``r`` as its *block*, a store whose arrays carry a leading [1] axis,
    as ``shard_map`` hands a device its block, and every pass is the
    reference's SPMD program with its collectives over the group
    (``repro_torch.distributed.collectives``).  Every member takes the
    same global arguments and returns the same full answers.

Each shard's pass is the port's own ``store.bulk_apply``, ``bulk_range``,
``bulk_lookup`` or ``range_query`` on that shard's view
(``store.shard_view``).

  apply :  ONE mixed-op pass per shard.  Op i of the global announce
           array runs at global timestamp ``base + i`` on whichever shard
           owns its key, so the sharded linearization is bit-identical to
           the single-device one, version timestamps included.
             * replicated (``make_apply``): every shard takes the whole
               announce array and NOPs the ops it does not own.
             * routed (``make_routed_apply``): each source slice packs its
               ops by owner into a [n_shards, cap] staging buffer, the
               buffers are exchanged, and each owner applies its subset at
               the ops' original global timestamps.  An owner owed more
               than its budget makes the pass return ``ok=False``; the
               host then falls back to the replicated pass.
  update:  INSERT/DELETE codes derived from the (keys, values) encoding.
  lookup:  each shard answers the keys it owns.
  range :  every shard runs one ``bulk_range`` pass over its own leaves
           and the blocks are merged by key (``make_range_apply``),
           clamped to the lowest truncated shard's resume point so pages
           stay exact; the single-interval ``range_q`` of
           :func:`make_ops` returns per-shard blocks.

The clock needs no communication: every shard advances its local ts to
``base + G`` per batch whatever it owns, so the shards' clocks agree —
the paper's FAA becomes a replicated counter.  On ``ok=False`` the input
store stays valid (a pass never writes into its input) and is retried.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import _ops as O
from repro_torch.core import store as S
from repro_torch.core.batch import _bump
from repro_torch.core.ref import KEY_MAX, NOT_FOUND, OP_NOP, OP_RANGE
from repro_torch.distributed import collectives as C

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    base: S.UruvConfig
    key_lo: int = 0
    key_hi: int = 1 << 30
    axis_name: str = "data"

    def span(self, n_shards: int) -> int:
        return -(-(self.key_hi - self.key_lo) // n_shards)


def create(cfg: ShardedConfig, mesh) -> S.UruvStore:
    """A stacked store on ``mesh.device``: every array gains a leading
    [n_shards] axis, each shard an empty store of ``cfg.base``; over a
    group, this member's [1] block."""
    n = 1 if mesh.group is not None else mesh.shape[cfg.axis_name]
    proto = S.create(cfg.base, mesh.device)
    return S.stack_shards([proto] * n)


def _block(store: S.UruvStore) -> S.UruvStore:
    """The one shard of a member's [1] block (a view)."""
    return S.shard_view(store, 0)


def _flag(cond, dev) -> torch.Tensor:
    """A [1] int32 tensor, 1 where ``cond`` (a bool or a bool tensor)."""
    return torch.as_tensor(cond, device=dev).to(I32).reshape(1)


def _owner(cfg: ShardedConfig, keys: torch.Tensor,
           n_shards: int) -> torch.Tensor:
    """The shard that owns each key: floor division by the span, clipped
    to [0, n_shards - 1] (KEY_MAX pads land on the last shard)."""
    span = cfg.span(n_shards)
    return torch.div(keys - cfg.key_lo, span, rounding_mode="floor").clamp(
        0, n_shards - 1).to(I32)


def _mixed_core(cfg: ShardedConfig, n_shards: int, store: S.UruvStore,
                codes, keys, values, light_path: bool = True, group=None):
    """Apply the replicated mixed announce on every shard: ops a shard does
    not own become NOPs, per-op global timestamps keep the announce-order
    linearization exact across shards."""
    dev = store.device
    codes, keys, values = (S._i32(x, dev) for x in (codes, keys, values))
    G = keys.shape[0]
    owner = _owner(cfg, keys, n_shards)
    if group is not None:
        mine = (owner == C.axis_index(group)) & (keys < KEY_MAX)
        st = _block(store)
        new, res, ok = S.bulk_apply(
            st, torch.where(mine, codes, OP_NOP),
            torch.where(mine, keys, KEY_MAX), values,
            op_ts=st.ts + O.arange32(G, dev), next_ts=st.ts + G,
            light_path=light_path)
        # one psum: the results' contributions (JAX's :104) and, last,
        # this member's rejection (ok summed as in JAX's :105)
        total = C.psum(torch.cat([torch.where(mine, res - NOT_FOUND, 0),
                                  _flag(not ok, dev)]), group)
        return (S.stack_shards([new], base=store), total[:G] + NOT_FOUND,
                not bool(total[G]))
    res_all = torch.full((G,), NOT_FOUND, dtype=I32, device=dev)
    news, ok_all = [], True
    for s, st in enumerate(S.shard_views(store)):
        mine = (owner == s) & (keys < KEY_MAX)
        new, res, ok = S.bulk_apply(
            st, torch.where(mine, codes, OP_NOP),
            torch.where(mine, keys, KEY_MAX), values,
            op_ts=st.ts + O.arange32(G, dev), next_ts=st.ts + G,
            light_path=light_path)
        res_all = torch.where(mine, res, res_all)
        news.append(new)
        ok_all = ok_all and ok
    return S.stack_shards(news, base=store), res_all, ok_all


def make_apply(cfg: ShardedConfig, mesh, *, light_path: bool = True):
    """The mixed-op pass over a *replicated* announce array:
    ``(store, op_codes[G], keys[G], values[G]) -> (store, results[G],
    ok)``.

    On ``ok=False`` the returned store is cross-shard INCONSISTENT (shards
    that succeeded applied their ops and advanced their clocks; the
    rejecting shard did not): callers discard it and retry from the input
    store, e.g. via :func:`sharded_apply_batch`.  The ``update`` op of
    :func:`make_ops` has the same contract.
    """
    n_shards = mesh.shape[cfg.axis_name]

    def apply(store, codes, keys, values):
        return _mixed_core(cfg, n_shards, store, codes, keys, values,
                           light_path, mesh.group)

    return apply


def make_routed_apply(cfg: ShardedConfig, mesh, *, route_factor: int = 2,
                      light_path: bool = True):
    """The mixed-op pass over a *sharded* announce array (global width G a
    multiple of the shard count; see :func:`pad_announce`).

    Source slice ``s`` (announce positions [s W, (s+1) W)) packs its ops
    by owner into a [n_shards, cap] staging buffer (cap = ceil(W *
    route_factor / n_shards)); the exchange hands owner ``d`` the rows
    ``[src, d]``, flattened in source order, so its valid ops stay
    announce-ordered and apply at ``op_ts = base + global position``.  If
    an owner is owed more ops than its budget, the pass returns
    ``ok=False`` with the ops only partly applied: callers discard the
    returned store and retry through the replicated pass.
    """
    n = mesh.shape[cfg.axis_name]
    if mesh.group is not None:
        return _routed_over_group(cfg, mesh.group, route_factor, light_path)

    def routed(store, codes, keys, values):
        dev = store.device
        codes, keys, values = (S._i32(x, dev)
                               for x in (codes, keys, values))
        G = keys.shape[0]
        W, cap = _route_width(G, n, route_factor)
        pos = O.arange32(G, dev)
        row, col, lost = _route_slots(cfg, n, codes.view(n, W),
                                      keys.view(n, W), cap)
        src = O.arange32(n, dev)[:, None].expand(n, W).long()

        def stage(fill, x):
            buf = torch.full((n, n + 1, cap), fill, dtype=I32, device=dev)
            buf[src, row, col] = x.view(n, W)
            # the exchange: owner d receives row [src, d] of every source
            return buf[:, :n].transpose(0, 1)                # [dst, src, cap]

        rcodes, rkeys, rvals, rpos = (stage(f, x) for f, x in (
            (OP_NOP, codes), (KEY_MAX, keys), (0, values), (0, pos)))
        contrib = torch.full((G + 1,), NOT_FOUND, dtype=I32, device=dev)
        news, ok_all = [], not bool(lost)
        for d, st in enumerate(S.shard_views(store)):
            fkeys, fpos = rkeys[d].reshape(-1), rpos[d].reshape(-1)
            new, res, ok = S.bulk_apply(
                st, rcodes[d].reshape(-1), fkeys, rvals[d].reshape(-1),
                op_ts=st.ts + fpos, next_ts=st.ts + G,
                light_path=light_path)
            # each routed op lands at its own position, once
            at = torch.where(fkeys < KEY_MAX, fpos, G).long()
            contrib.scatter_(0, at, res)
            news.append(new)
            ok_all = ok_all and ok
        return S.stack_shards(news, base=store), contrib[:G], ok_all

    return routed


def _route_width(G: int, n: int, route_factor: int) -> Tuple[int, int]:
    """A source slice's width W and an owner's budget cap of one routed
    pass over a width-``G`` announce."""
    if G % n:
        raise ValueError(f"routed width {G} is not a multiple of "
                         f"{n} shards (pad_announce)")
    W = G // n
    return W, max(1, -(-(W * route_factor) // n))


def _route_slots(cfg: ShardedConfig, n: int, codes: torch.Tensor,
                 keys: torch.Tensor, cap: int):
    """Where each op of a source slice (``[..., W]``) goes in its
    [n, cap] staging: its owner row (``n`` for a NOP, a pad, or an op past
    its owner's budget) and its column (its rank among the slice's ops
    for that owner); and whether any op was past its budget (a device
    bool)."""
    route = (keys < KEY_MAX) & (codes != OP_NOP)
    owner = torch.where(route, _owner(cfg, keys, n), n)
    onehot = owner[..., None] == O.arange32(n, keys.device)  # [..., W, dst]
    slot = torch.cumsum(onehot.to(I32), -2, dtype=I32).gather(
        -1, owner.clamp_max(n - 1).long()[..., None])[..., 0] - 1
    kept = (owner < n) & (slot < cap)
    lost = ((owner < n) & (slot >= cap)).any()
    return (torch.where(kept, owner, n).long(),
            slot.clamp(0, cap - 1).long(), lost)


def _routed_over_group(cfg: ShardedConfig, group, route_factor: int,
                       light_path: bool):
    """The routed pass as the reference's SPMD program (JAX's
    ``:158-202``): this member's slice of the announce is staged
    [n, cap], exchanged by one ``all_to_all`` per array, applied, and the
    results, the lost flag and ``ok`` are summed over the group."""
    n, me = C.axis_size(group), C.axis_index(group)

    def routed(store, codes, keys, values):
        dev = store.device
        codes, keys, values = (S._i32(x, dev)
                               for x in (codes, keys, values))
        G = keys.shape[0]
        W, cap = _route_width(G, n, route_factor)
        mine = slice(me * W, (me + 1) * W)
        row, col, lost = _route_slots(cfg, n, codes[mine], keys[mine], cap)

        def stage(fill, x):
            buf = torch.full((n + 1, cap), fill, dtype=I32, device=dev)
            buf[row, col] = x
            return C.all_to_all(buf[:n], group)              # [src, cap]

        # row s of each received buffer came from source s, positions
        # [s W, (s+1) W) packed in order: flattened, the valid ops stay
        # announce-ordered, as bulk_apply's op_ts contract requires
        rcodes, rkeys, rvals, rpos = (stage(f, x) for f, x in (
            (OP_NOP, codes[mine]), (KEY_MAX, keys[mine]),
            (0, values[mine]), (0, me * W + O.arange32(W, dev))))
        fkeys, fpos = rkeys.reshape(-1), rpos.reshape(-1)
        st = _block(store)
        new, res, ok = S.bulk_apply(
            st, rcodes.reshape(-1), fkeys, rvals.reshape(-1),
            op_ts=st.ts + fpos, next_ts=st.ts + G, light_path=light_path)
        valid = fkeys < KEY_MAX
        part = torch.zeros(G + 1, dtype=I32, device=dev)
        part.scatter_(0, torch.where(valid, fpos, G).long(),
                      torch.where(valid, res - NOT_FOUND, 0))
        part[G:] = _flag(lost, dev) | int(not ok)
        total = C.psum(part, group)
        return (S.stack_shards([new], base=store), total[:G] + NOT_FOUND,
                not bool(total[G]))

    return routed


def make_range_apply(cfg: ShardedConfig, mesh, *, max_results: int = 1024,
                     scan_leaves: int = 16, max_rounds: int = 8):
    """Batched range search over a *replicated* query array:
    ``(store, k1[Q], k2[Q], snap_ts[Q]) -> (keys[Q, R], values[Q, R],
    count[Q], truncated[Q], resume_k1[Q])``.

    Every shard answers all Q intervals against its OWN leaves in one
    ``store.bulk_range`` pass; the blocks are stacked and merged by key.
    Valid keys are unique across shards (each lives on its owner), so a
    stable sort on the keys and a gather of the values is the merge.
    Shards share the replicated clock and per-op timestamps, so the rows —
    values and their snapshot resolution — equal single-device
    ``bulk_range`` whenever neither side budget-truncates.  The leaf
    budget is pooled PER SHARD.

    Exactness under truncation: a truncated shard has covered only the
    keys below its ``resume_k1``, so the merge clamps to the lowest
    truncated shard's resume point (the frontier) before taking the R
    smallest keys; the merged ``resume_k1`` paginates exactly as on one
    device.
    """
    R = max_results
    group = mesh.group

    def range_apply(store, k1, k2, snap):
        dev = store.device
        k1 = S._i32(k1, dev).reshape(-1)
        k2 = S._i32(k2, dev).reshape(-1)
        snap = S._i32(snap, dev).expand(k1.shape)
        outs = [S.bulk_range(st, k1, k2, snap, max_results=R,
                             scan_leaves=scan_leaves, max_rounds=max_rounds)
                for st in S.shard_views(store)]
        if group is None:
            allk, allv, _, allt, allr = (torch.stack(x) for x in zip(*outs))
        else:
            # JAX's four all_gathers (:254-257) as one, of the packed
            # [Q, 2R + 2] block: keys, values, truncated, resume
            keys, vals, _, trunc, resume = outs[0]
            allp = C.all_gather(torch.cat(
                [keys, vals, trunc.to(I32)[:, None], resume[:, None]], 1),
                group)                                       # [n, Q, 2R+2]
            allk, allv = allp[..., :R], allp[..., R:2 * R]
            allt, allr = allp[..., 2 * R].bool(), allp[..., 2 * R + 1]
        return _merge_ranges(allk, allv, allt, allr, k2, R)

    return range_apply


def _merge_ranges(allk, allv, allt, allr, k2, R: int):
    """The shards' ``bulk_range`` blocks (``[n, Q, R]`` keys and values,
    ``[n, Q]`` truncated flags and resume points) merged by key and
    clamped to the frontier (JAX's ``:258-276``)."""
    n, Q = allk.shape[:2]
    ceil = torch.where(allt, allr, KEY_MAX).amin(0)             # [Q]
    mk = allk.transpose(0, 1).reshape(Q, n * R)
    mv = allv.transpose(0, 1).reshape(Q, n * R)
    keep = mk < ceil[:, None]      # drops padding AND beyond-frontier
    mk = torch.where(keep, mk, KEY_MAX)
    mv = torch.where(keep, mv, NOT_FOUND)
    sk, perm = torch.sort(mk, dim=1, stable=True)
    sv = mv.gather(1, perm)
    total = keep.sum(1, dtype=I32)
    count = total.clamp_max(R)
    out_keys, out_vals = sk[:, :R], sv[:, :R]
    overflow = total > R
    clamped = ceil < KEY_MAX
    last = out_keys.gather(1, (count - 1).clamp_min(0).long()[:, None])
    resume = torch.where(overflow, last[:, 0] + 1,
                         torch.where(clamped, ceil, k2))
    return out_keys, out_vals, count, overflow | clamped, resume


def pad_announce(codes, keys, values, multiple: int):
    """Pad a host announce array with NOPs to a width multiple (routing)."""
    codes = np.asarray(codes, np.int32)
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    r = (-len(keys)) % multiple
    if r:
        codes = np.concatenate([codes, np.full(r, OP_NOP, np.int32)])
        keys = np.concatenate([keys, np.full(r, KEY_MAX, np.int32)])
        values = np.concatenate([values, np.zeros(r, np.int32)])
    return codes, keys, values


def _oflow_bits(store: S.UruvStore, group=None) -> int:
    """The OR of every shard's ``OFLOW_*`` bits (over the group too)."""
    bits = store.oflow.reshape(-1)
    if group is not None:
        bits = C.bitwise_or(bits, group)
    return int(np.bitwise_or.reduce(bits.cpu().numpy()))


def sharded_apply_batch(store, codes, keys, values, *, apply_fn,
                        routed_fn=None, stats=None, group=None):
    """Host fast/slow sequencing: the routed pass first, the replicated
    pass as its fallback.  Returns ``(store, results[G])``.

    Raises ``RuntimeError`` if even the replicated pass rejects
    (capacity); the error carries the OR of the rejecting shards' fresh
    ``OFLOW_*`` bits as ``.oflow_reason`` (over ``group``, the mesh's, for
    a member's block) so the caller's lifecycle policy
    (``repro_torch.api.ShardedExecutor``) can relieve the right pool.
    CRUD codes only: RANGE announce arrays go through
    :func:`make_range_apply`.
    """
    if np.any(np.asarray(codes) == OP_RANGE):
        raise ValueError(
            "sharded_apply_batch handles SEARCH/INSERT/DELETE/NOP only; "
            "answer OP_RANGE announce arrays via make_range_apply")
    if routed_fn is not None:
        _bump(stats, "device_passes")
        new_store, res, ok = routed_fn(store, codes, keys, values)
        if ok:
            return new_store, res.cpu().numpy()
        # routing budget exceeded: discard the partial store, fall back
    _bump(stats, "device_passes")
    new_store, res, ok = apply_fn(store, codes, keys, values)
    if not ok:
        err = RuntimeError(
            "sharded announce rejected by every shard path (capacity); "
            "grow/compact or widen the shard stores")
        err.oflow_reason = (_oflow_bits(new_store, group)
                            & ~_oflow_bits(store, group))
        raise err
    return new_store, res.cpu().numpy()


def make_ops(cfg: ShardedConfig, mesh):
    """The (update, lookup, range_q) ops over a stacked store (or, over a
    group, a member's block: every member gets the whole answer).

    ``update(store, keys, values)`` shares :func:`make_apply`'s rejection
    contract.  ``lookup(store, keys, snap)`` answers each key on its
    owner (summed over the group, JAX's ``psum``).  ``range_q(store, k1,
    k2, snap, *, max_scan_leaves=64, max_results=1024)`` is the paper's
    single-interval RANGEQUERY on every shard: per-shard ``(keys[n, R],
    values[n, R], count[n], truncated[n])`` blocks, over a group gathered
    to every member as JAX's ``out_specs=P(ax)`` gives them
    (:func:`merge_range_results` joins them).
    """
    n = mesh.shape[cfg.axis_name]
    group = mesh.group
    first = 0 if group is None else C.axis_index(group)

    def update(store, keys, values):
        keys = np.asarray(keys, np.int32)
        values = np.asarray(values, np.int32)
        codes = S.derive_update_codes(keys, values)
        return _mixed_core(cfg, n, store, codes, keys, values, group=group)

    def lookup(store, keys, snap):
        keys = S._i32(keys, store.device).reshape(-1)
        owner = _owner(cfg, keys, n)
        out = torch.full_like(keys, NOT_FOUND)
        for s, st in enumerate(S.shard_views(store), first):
            mine = owner == s
            vals = S.bulk_lookup(st, torch.where(mine & (keys < KEY_MAX),
                                                 keys, KEY_MAX), snap)
            out = torch.where(mine, vals, out)
        if group is not None:
            out = C.psum(out - NOT_FOUND, group) + NOT_FOUND
        return out

    def range_q(store, k1, k2, snap, *, max_scan_leaves: int = 64,
                max_results: int = 1024):
        outs = [S.range_query(st, k1, k2, snap,
                              max_scan_leaves=max_scan_leaves,
                              max_results=max_results)
                for st in S.shard_views(store)]
        keys, vals, cnt, trunc = (torch.stack(x) for x in zip(*outs))
        if group is None:
            return keys, vals, cnt, trunc
        R = keys.shape[1]
        allp = C.all_gather(torch.cat([keys[0], vals[0], cnt.to(I32),
                                       trunc.to(I32)]), group)  # [n, 2R+2]
        return (allp[:, :R], allp[:, R:2 * R], allp[:, 2 * R],
                allp[:, 2 * R + 1].bool())

    return update, lookup, range_q


def merge_range_results(keys, vals, counts) -> List[Tuple[int, int]]:
    """Host-side merge of per-shard range results (shards are key-ordered)."""
    keys, vals, counts = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                          for x in (keys, vals, counts))
    out = []
    for s in range(keys.shape[0]):
        c = int(counts[s])
        out.extend(zip(keys[s, :c].tolist(), vals[s, :c].tolist()))
    return out


def global_ts(store: S.UruvStore) -> int:
    """The replicated FAA counter (identical on every shard)."""
    return int(store.ts[0])


def sharded_snapshot(store: S.UruvStore):
    """Register a snapshot on every shard (replicated tracker)."""
    snap = global_ts(store)
    new = S.stack_shards([S.snapshot(st)[0] for st in S.shard_views(store)],
                         base=store)
    return new, snap


def sharded_release(store: S.UruvStore, snap: int) -> S.UruvStore:
    return S.stack_shards([S.release(st, snap)
                           for st in S.shard_views(store)], base=store)
