"""Key-range-sharded Uruv: one store per shard, stacked on one device.

A port of the JAX package's ``repro.core.sharded``.  The key space is
range-partitioned into ``n_shards`` spans; a sharded store is ONE stacked
store whose every array carries a leading [n_shards] axis, shard ``s``
owning the keys of span ``s``.  Here every shard lives on the mesh's one
device, and the reference's collectives become tensor operations along
the shard axis: ``psum`` a sum (a select: exactly one shard owns an op),
``all_gather`` the stack of the shards' outputs, ``all_to_all`` the
transpose of the [src, dst, cap] staging, ``axis_index`` the shard's
index.  Each shard's pass is the port's own ``store.bulk_apply``,
``bulk_range``, ``bulk_lookup`` or ``range_query`` on that shard's view
(``store.shard_view``), so on the card the store kernels run once per
shard per pass.

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
    [n_shards] axis, each shard an empty store of ``cfg.base``."""
    n = mesh.shape[cfg.axis_name]
    proto = S.create(cfg.base, mesh.device)
    return S.stack_shards([proto] * n)


def _owner(cfg: ShardedConfig, keys: torch.Tensor,
           n_shards: int) -> torch.Tensor:
    """The shard that owns each key: floor division by the span, clipped
    to [0, n_shards - 1] (KEY_MAX pads land on the last shard)."""
    span = cfg.span(n_shards)
    return torch.div(keys - cfg.key_lo, span, rounding_mode="floor").clamp(
        0, n_shards - 1).to(I32)


def _mixed_core(cfg: ShardedConfig, n_shards: int, store: S.UruvStore,
                codes, keys, values, light_path: bool = True):
    """Apply the replicated mixed announce on every shard: ops a shard does
    not own become NOPs, per-op global timestamps keep the announce-order
    linearization exact across shards."""
    dev = store.device
    codes, keys, values = (S._i32(x, dev) for x in (codes, keys, values))
    G = keys.shape[0]
    owner = _owner(cfg, keys, n_shards)
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
                           light_path)

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

    def routed(store, codes, keys, values):
        dev = store.device
        codes, keys, values = (S._i32(x, dev)
                               for x in (codes, keys, values))
        G = keys.shape[0]
        if G % n:
            raise ValueError(f"routed width {G} is not a multiple of "
                             f"{n} shards (pad_announce)")
        W = G // n
        cap = max(1, -(-(W * route_factor) // n))
        pos = O.arange32(G, dev)
        route = (keys < KEY_MAX) & (codes != OP_NOP)
        owner = torch.where(route, _owner(cfg, keys, n), n).view(n, W)
        onehot = owner[..., None] == O.arange32(n, dev)      # [src, W, dst]
        rank = torch.cumsum(onehot.to(I32), 1, dtype=I32).gather(
            2, owner.clamp_max(n - 1).long()[..., None])[..., 0] - 1
        routed_ = (owner < n) & (rank < cap)
        lost = bool(((owner < n) & (rank >= cap)).any())
        src = O.arange32(n, dev)[:, None].expand(n, W).long()
        row = torch.where(routed_, owner, n).long()          # n: dropped
        col = rank.clamp(0, cap - 1).long()

        def stage(fill, x):
            buf = torch.full((n, n + 1, cap), fill, dtype=I32, device=dev)
            buf[src, row, col] = x.view(n, W)
            # the exchange: owner d receives row [src, d] of every source
            return buf[:, :n].transpose(0, 1)                # [dst, src, cap]

        rcodes, rkeys, rvals, rpos = (stage(f, x) for f, x in (
            (OP_NOP, codes), (KEY_MAX, keys), (0, values), (0, pos)))
        contrib = torch.full((G + 1,), NOT_FOUND, dtype=I32, device=dev)
        news, ok_all = [], not lost
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
    n = mesh.shape[cfg.axis_name]
    R = max_results

    def range_apply(store, k1, k2, snap):
        dev = store.device
        k1 = S._i32(k1, dev).reshape(-1)
        k2 = S._i32(k2, dev).reshape(-1)
        snap = S._i32(snap, dev).expand(k1.shape)
        Q = k1.shape[0]
        outs = [S.bulk_range(st, k1, k2, snap, max_results=R,
                             scan_leaves=scan_leaves, max_rounds=max_rounds)
                for st in S.shard_views(store)]
        allk, allv, _, allt, allr = (torch.stack(x) for x in zip(*outs))
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

    return range_apply


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


def _oflow_bits(store: S.UruvStore) -> int:
    return int(np.bitwise_or.reduce(store.oflow.cpu().numpy().reshape(-1)))


def sharded_apply_batch(store, codes, keys, values, *, apply_fn,
                        routed_fn=None, stats=None):
    """Host fast/slow sequencing: the routed pass first, the replicated
    pass as its fallback.  Returns ``(store, results[G])``.

    Raises ``RuntimeError`` if even the replicated pass rejects
    (capacity); the error carries the OR of the rejecting shards' fresh
    ``OFLOW_*`` bits as ``.oflow_reason`` so the caller's lifecycle policy
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
        err.oflow_reason = _oflow_bits(new_store) & ~_oflow_bits(store)
        raise err
    return new_store, res.cpu().numpy()


def make_ops(cfg: ShardedConfig, mesh):
    """The (update, lookup, range_q) ops over a stacked store.

    ``update(store, keys, values)`` shares :func:`make_apply`'s rejection
    contract.  ``lookup(store, keys, snap)`` answers each key on its
    owner.  ``range_q(store, k1, k2, snap, *, max_scan_leaves=64,
    max_results=1024)`` is the paper's single-interval RANGEQUERY on every
    shard: per-shard ``(keys[n, R], values[n, R], count[n],
    truncated[n])`` blocks (:func:`merge_range_results` joins them).
    """
    n = mesh.shape[cfg.axis_name]

    def update(store, keys, values):
        keys = np.asarray(keys, np.int32)
        values = np.asarray(values, np.int32)
        codes = S.derive_update_codes(keys, values)
        return _mixed_core(cfg, n, store, codes, keys, values)

    def lookup(store, keys, snap):
        keys = S._i32(keys, store.device).reshape(-1)
        owner = _owner(cfg, keys, n)
        out = torch.full_like(keys, NOT_FOUND)
        for s, st in enumerate(S.shard_views(store)):
            mine = owner == s
            vals = S.bulk_lookup(st, torch.where(mine & (keys < KEY_MAX),
                                                 keys, KEY_MAX), snap)
            out = torch.where(mine, vals, out)
        return out

    def range_q(store, k1, k2, snap, *, max_scan_leaves: int = 64,
                max_results: int = 1024):
        outs = [S.range_query(st, k1, k2, snap,
                              max_scan_leaves=max_scan_leaves,
                              max_results=max_results)
                for st in S.shard_views(store)]
        return tuple(torch.stack(x) for x in zip(*outs))

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
