"""UruvStore in PyTorch — the paper's B+-tree + MVCC key-value store.

A port of the JAX package's ``repro.core.store`` (DESIGN.md Sec 2): a
leaf pool of sorted fat leaves with version-chain heads, the fat-node
index of ``repro_torch.core.index``, a bump-allocated version pool and a
version-tracker ring.  Field names, dtypes and every array match the JAX
``UruvStore``, so a store carried across with :func:`from_numpy` /
:func:`to_numpy` is bit-equal on both sides, and the same plans give the
same store.

A pass never writes into its input tensors: every update goes into a
fresh copy (``repro_torch.core._ops``), so an older store stays a valid
frozen snapshot, as the combining layer's rollback relies on.  The
store's device decides where everything runs; the hot paths go through
``repro_torch.core.backend`` (the CUDA kernels on the card, their plain
twins on the CPU).

Host syncs: where the reference branches on device values with
``lax.cond``, this port reads them on the host.  A ``bulk_apply`` pass
syncs once to decide whether the structural phase runs (and whether the
batch is accepted), and once more after a structural phase to read the
index delta's overflow flag; the reference's per-level index cond and
its "any search to resolve?" cond are computed unconditionally instead
(same result, no sync).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import _ops as O
from repro_torch.core import backend as _B
from repro_torch.core import index as _I
from repro_torch.core.ref import (
    KEY_MAX, KEY_MIN, NOT_FOUND, OP_DELETE, OP_INSERT, OP_NOP, OP_SEARCH,
    TOMBSTONE,
)

I32 = torch.int32

# Overflow flag bits (store.oflow)
OFLOW_VERSIONS = 1
OFLOW_LEAVES = 2
OFLOW_TRACKER = 4
OFLOW_LEAFBATCH = 8   # > L new keys routed to a single leaf (slow-path signal)
OFLOW_INDEX = 16      # index node pool / root overflow -> reindex


def resolve_device(device=None) -> torch.device:
    """The device a store lives on: ``cuda`` unless the caller asks for
    something else.  Raises when CUDA is asked for and absent — there is
    no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the store runs on the card by default "
            "(pass device='cpu' for the plain PyTorch path)")
    return dev


@dataclasses.dataclass(frozen=True)
class UruvConfig:
    """Static capacities."""

    leaf_cap: int = 32          # L — max keys per leaf (paper's MAX)
    max_leaves: int = 4096      # ML — leaf pool size
    max_versions: int = 1 << 16  # MV — version pool size
    tracker_cap: int = 128      # MT — version-tracker ring size
    max_chain: int = 64         # bound on version-chain walks / GC retention
    index_fanout: int = 16      # F — entries per internal fat node

    @property
    def min_fill(self) -> int:  # paper's MIN
        return self.leaf_cap // 4

    @property
    def pack_fill(self) -> int:  # occupancy target after compact()
        return max(1, (3 * self.leaf_cap) // 4)

    def index_config(self) -> "_I.IndexConfig":
        return _I.index_config(self.max_leaves, self.index_fanout)


@dataclasses.dataclass
class UruvStore:
    # --- leaf pool ---
    leaf_keys: torch.Tensor    # int32 [ML, L], sorted rows, KEY_MAX padded
    leaf_vhead: torch.Tensor   # int32 [ML, L], -1 where empty
    leaf_count: torch.Tensor   # int32 [ML]
    leaf_next: torch.Tensor    # int32 [ML], -1 = end (paper: next)
    leaf_newnext: torch.Tensor  # int32 [ML], -1 = unset (paper: newNext)
    leaf_frozen: torch.Tensor  # bool  [ML] (paper: frozen)
    leaf_ts: torch.Tensor      # int32 [ML] creation timestamp (paper: ts)
    n_alloc: torch.Tensor      # int32 [] bump allocator over the leaf pool
    # --- internal index (multi-level fat nodes) ---
    index: _I.UruvIndex
    n_leaves: torch.Tensor     # int32 [] live leaves (== live separators)
    # --- version pool ---
    ver_value: torch.Tensor    # int32 [MV]
    ver_ts: torch.Tensor       # int32 [MV]
    ver_next: torch.Tensor     # int32 [MV], -1 = end
    n_vers: torch.Tensor       # int32 []
    # --- clock + tracker ---
    ts: torch.Tensor           # int32 [] global timestamp (paper's FAA counter)
    trk_ts: torch.Tensor       # int32 [MT]
    trk_active: torch.Tensor   # bool  [MT]
    trk_cursor: torch.Tensor   # int32 [] ring cursor
    # --- status ---
    oflow: torch.Tensor        # int32 [] bitmask of OFLOW_*
    cfg: UruvConfig

    @property
    def device(self) -> torch.device:
        return self.leaf_keys.device


def create(cfg: UruvConfig = UruvConfig(), device=None) -> UruvStore:
    """An empty store on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    ML, L, MV, MT = cfg.max_leaves, cfg.leaf_cap, cfg.max_versions, cfg.tracker_cap

    def full(shape, v, dtype=I32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=I32, device=dev)

    sep_keys = full((ML,), KEY_MAX)
    sep_keys[0] = KEY_MIN
    sep_leaf = full((ML,), -1)
    sep_leaf[0] = 0
    return UruvStore(
        leaf_keys=full((ML, L), KEY_MAX),
        leaf_vhead=full((ML, L), -1),
        leaf_count=full((ML,), 0),
        leaf_next=full((ML,), -1),
        leaf_newnext=full((ML,), -1),
        leaf_frozen=full((ML,), False, torch.bool),
        leaf_ts=full((ML,), 0),
        n_alloc=scalar(1),                  # leaf 0 is the initial empty leaf
        index=_I.build(cfg.index_config(), ML, sep_keys, sep_leaf, 1),
        n_leaves=scalar(1),
        ver_value=full((MV,), 0),
        ver_ts=full((MV,), 0),
        ver_next=full((MV,), -1),
        n_vers=scalar(0),
        ts=scalar(0),
        trk_ts=full((MT,), 0),
        trk_active=full((MT,), False, torch.bool),
        trk_cursor=scalar(0),
        oflow=scalar(0),
        cfg=cfg,
    )


# ---------------------------------------------------------------------------
# State carried across: flat numpy arrays by field name
# ---------------------------------------------------------------------------

_INDEX_LEVEL_FIELDS = ("node_keys", "node_child", "node_cnt")


def to_numpy(store: UruvStore) -> Dict[str, np.ndarray]:
    """Every store array as numpy, keyed by field name; the index's fields
    as ``index.<name>`` and its levels as ``index.<name>.<l>``."""
    out = {}
    for f in dataclasses.fields(UruvStore):
        v = getattr(store, f.name)
        if f.name == "cfg":
            continue
        if f.name == "index":
            for g in dataclasses.fields(_I.UruvIndex):
                w = getattr(v, g.name)
                if g.name == "cfg":
                    continue
                if g.name in _INDEX_LEVEL_FIELDS:
                    for l, t in enumerate(w):
                        out[f"index.{g.name}.{l}"] = t.cpu().numpy()
                else:
                    out[f"index.{g.name}"] = w.cpu().numpy()
            continue
        out[f.name] = v.cpu().numpy()
    return out


def from_numpy(arrays: Dict[str, np.ndarray], cfg: UruvConfig,
               device=None) -> UruvStore:
    """The store whose arrays are ``arrays`` (the :func:`to_numpy` layout,
    e.g. a JAX store flattened by field name), on ``device``."""
    dev = resolve_device(device)

    def t(name):
        a = np.asarray(arrays[name])
        dtype = torch.bool if a.dtype == np.bool_ else I32
        return torch.as_tensor(a.astype(np.bool_ if dtype == torch.bool
                                         else np.int32), device=dev).to(dtype)

    icfg = cfg.index_config()
    ix = {}
    for g in dataclasses.fields(_I.UruvIndex):
        if g.name == "cfg":
            continue
        if g.name in _INDEX_LEVEL_FIELDS:
            ix[g.name] = [t(f"index.{g.name}.{l}") for l in range(icfg.depth)]
        else:
            ix[g.name] = t(f"index.{g.name}")
    kw = {f.name: t(f.name) for f in dataclasses.fields(UruvStore)
          if f.name not in ("index", "cfg")}
    return UruvStore(index=_I.UruvIndex(cfg=icfg, **ix), cfg=cfg, **kw)


def _i32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32) if not torch.is_tensor(x)
                           else x, dtype=I32, device=dev)


# ---------------------------------------------------------------------------
# Locate + resolve (through repro_torch.core.backend)
# ---------------------------------------------------------------------------

def _locate(store: UruvStore, keys: torch.Tensor):
    """Root->leaf traversal: (bnode, bslot, leaf_id, slot, exists, vhead)."""
    return _B.locate(store.index, store.leaf_keys, store.leaf_vhead, keys)


def _resolve(store: UruvStore, vhead: torch.Tensor, snap_ts) -> torch.Tensor:
    """Versioned read: first version with ts <= snap (bounded walk)."""
    return _B.resolve(vhead, snap_ts, store.ver_ts, store.ver_next,
                      store.ver_value, max_chain=store.cfg.max_chain)


def bulk_lookup(store: UruvStore, keys, snap_ts) -> torch.Tensor:
    """Batched SEARCH at per-op snapshot timestamps (scalar or [P]).
    Padded (KEY_MAX) keys return NOT_FOUND; the clock does not move."""
    keys = _i32(keys, store.device)
    snap = _i32(snap_ts, store.device).expand(keys.shape)
    _, _, _, _, exists, vhead = _locate(store, keys)
    vals = _resolve(store, torch.where(exists, vhead, -1), snap)
    return torch.where(keys >= KEY_MAX, NOT_FOUND, vals)


# ---------------------------------------------------------------------------
# bulk_apply — one pass over a mixed announce array
# ---------------------------------------------------------------------------

def _latest_value(store: UruvStore, vhead: torch.Tensor) -> torch.Tensor:
    val = torch.where(vhead >= 0, store.ver_value[vhead.clamp_min(0)],
                      NOT_FOUND)
    return _tomb(val)


def _tomb(val: torch.Tensor) -> torch.Tensor:
    return torch.where(val == TOMBSTONE, NOT_FOUND, val)


def bulk_apply(store: UruvStore, op_codes, keys, values, base_ts=None, *,
               op_ts=None, next_ts=None, light_path: bool = True):
    """Apply a mixed announce array in one pass.

    ``op_codes[i]`` in {OP_SEARCH, OP_INSERT, OP_DELETE, OP_NOP}.  Op i
    runs at ``op_ts[i]`` (default ``base_ts + i``; ``base_ts`` defaults to
    ``store.ts``) and the clock advances to ``next_ts`` (default ``base_ts
    + P``).  Results are in announce order: INSERT/DELETE return the
    previous value, SEARCH the value at its per-op snapshot, NOP/padded
    keys NOT_FOUND.  Returns ``(new_store, results[P], ok)`` with ``ok`` a
    Python bool: ``False`` means the batch was rejected atomically (the
    returned store is the input with its ``oflow`` bits set) and must be
    retried through ``repro_torch.core.batch``.
    """
    dev = store.device
    cfg = store.cfg
    op_codes = _i32(op_codes, dev)
    keys = _i32(keys, dev)
    values = _i32(values, dev)
    P = keys.shape[0]
    L, ML, MV = cfg.leaf_cap, cfg.max_leaves, cfg.max_versions
    base_ts = store.ts if base_ts is None else _i32(base_ts, dev)
    op_ts = base_ts + O.arange32(P, dev) if op_ts is None else _i32(op_ts, dev)
    next_ts = base_ts + P if next_ts is None else _i32(next_ts, dev)

    is_upd = (op_codes == OP_INSERT) | (op_codes == OP_DELETE)
    is_search = op_codes == OP_SEARCH
    adt_keys = torch.where((is_upd | is_search) & (keys < KEY_MAX), keys,
                           KEY_MAX)
    upd_vals = torch.where(op_codes == OP_DELETE, TOMBSTONE, values)

    # ---- sort by (key, announce idx): a stable sort by key IS that order
    skeys, sidx = torch.sort(adt_keys, stable=True)
    svals, scodes, sop_ts = upd_vals[sidx], op_codes[sidx], op_ts[sidx]
    svalid = skeys < KEY_MAX
    upd_s = svalid & ((scodes == OP_INSERT) | (scodes == OP_DELETE))
    search_s = svalid & (scodes == OP_SEARCH)
    first_occ = svalid & torch.cat([torch.ones(1, dtype=torch.bool,
                                               device=dev),
                                    skeys[1:] != skeys[:-1]])

    # ---- locate all ops: ONE descent for updates and searches
    bnode, bslot, leaf_id, slot, exists, old_vhead = _locate(store, skeys)
    exists = exists & svalid
    F_I = cfg.index_fanout
    ENT_PAD = cfg.index_config().caps[0] * F_I     # grouping sentinel
    ent = bnode * F_I + bslot                      # bottom index entry id

    # ---- version slots: bump-allocate one per update op
    vslot = torch.where(upd_s, store.n_vers + O.cumsum32(upd_s) - 1, MV)
    nval = upd_s.sum(dtype=I32)

    # in-batch predecessor: the latest update before op i in its key group
    pos_arr = O.arange32(P, dev)
    seg_start = O.cummax(torch.where(first_occ, pos_arr, -1))
    upd_pos = torch.where(upd_s, pos_arr, -1)
    m_excl = O.shifted(O.cummax(upd_pos), -1)
    pred = torch.where(m_excl >= seg_start, m_excl, -1)
    predc = pred.clamp_min(0)
    vnext = torch.where(pred >= 0, vslot[predc], old_vhead)

    pred_val = _tomb(svals[predc])
    head_val = torch.where(exists, _latest_value(store, old_vhead), NOT_FOUND)
    prev_vals_sorted = torch.where(
        upd_s, torch.where(pred >= 0, pred_val, head_val), NOT_FOUND)
    # searches with no in-batch predecessor resolve on the pre-batch chain
    rhead = torch.where(search_s & (pred < 0) & exists, old_vhead, -1)
    resolved = _resolve(store, rhead, sop_ts)
    search_vals_sorted = torch.where(
        search_s, torch.where(pred >= 0, pred_val, resolved), NOT_FOUND)

    # per-group new vhead = version slot of the group's LAST update
    last_upd_of_seg = torch.full((P,), -1, dtype=I32, device=dev).scatter_reduce(
        0, torch.where(svalid, seg_start, P - 1).long(), upd_pos, "amax")
    group_vhead = torch.where(last_upd_of_seg >= 0,
                              vslot[last_upd_of_seg.clamp_min(0)], -1)
    lus = last_upd_of_seg[seg_start.clamp_min(0)]

    # ---- new-key groups (structural inserts), compacted to the front
    is_new = first_occ & ~exists & (last_upd_of_seg >= 0)
    n_new = is_new.sum(dtype=I32)
    order = torch.sort(torch.where(is_new, 0, 1).to(I32), stable=True).indices
    ckeys, cvhead, cleaf = skeys[order], group_vhead[order], leaf_id[order]
    cent = torch.where(is_new[order], ent[order], ENT_PAD)
    crank = pos_arr
    cval = crank < n_new
    boundary = cval & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                 cent[1:] != cent[:-1]])
    gid = O.cumsum32(boundary) - 1
    goffset = crank - O.cummax(torch.where(boundary, crank, -1))
    n_groups = boundary.sum(dtype=I32)
    brow = torch.where(boundary, gid, P - 1).long()
    gent = torch.full((P,), ENT_PAD, dtype=I32, device=dev).scatter_reduce(
        0, brow, torch.where(boundary, cent, ENT_PAD), "amin")
    gcount = torch.zeros(P, dtype=I32, device=dev).index_add_(
        0, torch.where(cval, gid, P - 1).long(), cval.to(I32))
    g_is_real = pos_arr < n_groups
    gleafs = torch.full((P,), ML, dtype=I32, device=dev).scatter_reduce(
        0, brow, torch.where(boundary, cleaf, ML), "amin")
    gleaf = torch.where(g_is_real, gleafs.clamp_max(ML - 1), 0)
    gold_count = torch.where(g_is_real, store.leaf_count[gleaf], 0)
    gord = _I.leaf_ordinal(store.index,
                           torch.where(g_is_real, gent // F_I, 0),
                           torch.where(g_is_real, gent % F_I, 0))

    n_splits = (g_is_real & (gold_count + gcount > L)).sum(dtype=I32)
    pre_overflow = (
        torch.where(store.n_vers + nval > MV, OFLOW_VERSIONS, 0)
        | torch.where(store.n_alloc + 2 * n_splits > ML, OFLOW_LEAVES, 0)
        | torch.where(store.n_leaves + n_splits > ML, OFLOW_LEAVES, 0)
        | torch.where((gcount > L).any(), OFLOW_LEAFBATCH, 0))

    # ---- existing-key vhead updates (group's last update only)
    upd = upd_s & exists & (pos_arr == lus)
    vh_buf = O.sinked(store.leaf_vhead)
    O.put(vh_buf, O.lin_elem(torch.where(upd, leaf_id, ML), slot, ML, L),
          vslot)

    # host sync 1: the reference's lax.cond on the structural phase
    pre_overflow_h, n_new_h = torch.stack([pre_overflow, n_new]).tolist()
    run_struct = pre_overflow_h == 0 and (n_new_h > 0 or not light_path)
    idx_oflow_h = False
    if run_struct:
        s = _structural(store, vh_buf, base_ts, P=P, L=L, ML=ML,
                        g_is_real=g_is_real, gleaf=gleaf, gcount=gcount,
                        gold_count=gold_count, gord=gord, cval=cval,
                        gid=gid, goffset=goffset, ckeys=ckeys, cvhead=cvhead,
                        n_splits=n_splits)
        idx_oflow_h = bool(s["idx_oflow"])        # host sync 2
    overflow = pre_overflow_h | (OFLOW_INDEX if idx_oflow_h else 0)
    ok = overflow == 0

    if ok:
        if not run_struct:
            s = dict(leaf_vhead=O.unsink(vh_buf, store.leaf_vhead.shape))
        ver = [O.sinked(t) for t in (store.ver_value, store.ver_ts,
                                     store.ver_next)]
        vlin = O.lin_1d(vslot, MV)
        for buf, v in zip(ver, (svals, sop_ts, vnext)):
            O.put(buf, vlin, v)
        new_store = dataclasses.replace(
            store,
            ver_value=O.unsink(ver[0], (MV,)),
            ver_ts=O.unsink(ver[1], (MV,)),
            ver_next=O.unsink(ver[2], (MV,)),
            n_vers=store.n_vers + nval,
            ts=next_ts.clone(),
            **{k: v for k, v in s.items() if k != "idx_oflow"},
        )
        res_sorted = torch.where(search_s, search_vals_sorted,
                                 prev_vals_sorted)
        results = torch.empty(P, dtype=I32, device=dev)
        results[sidx] = res_sorted
    else:
        new_store = dataclasses.replace(store, oflow=store.oflow | overflow)
        results = torch.full((P,), NOT_FOUND, dtype=I32, device=dev)
    return new_store, results, ok


def _structural(store, vh_buf, base_ts, *, P, L, ML, g_is_real, gleaf,
                gcount, gold_count, gord, cval, gid, goffset, ckeys, cvhead,
                n_splits):
    """The structural phase of :func:`bulk_apply`: merge the new keys into
    their leaves in a [P groups, 2L] workspace, split overflowing leaves,
    relink the leaf chain and apply the index's split delta.  Writes go
    into ``vh_buf`` (the pass's own leaf_vhead copy) and fresh copies of
    the other leaf arrays; returns the new fields plus ``idx_oflow``."""
    dev = store.device
    leaf_vhead0 = O.unsink(vh_buf, store.leaf_vhead.shape)
    wk_keys = torch.full((P, 2 * L), KEY_MAX, dtype=I32, device=dev)
    wk_vh = torch.full((P, 2 * L), -1, dtype=I32, device=dev)
    wk_keys[:, :L] = torch.where(g_is_real[:, None], store.leaf_keys[gleaf],
                                 KEY_MAX)
    wk_vh[:, :L] = torch.where(g_is_real[:, None], leaf_vhead0[gleaf], -1)
    # new (key, vhead) pairs go to L + offset within their group row
    lin = O.lin_elem(torch.where(cval, gid, P - 1),
                     torch.where(cval, L + goffset.clamp_max(L - 1), 2 * L),
                     P, 2 * L)
    wk_keys = O.drop_set(wk_keys, lin, torch.where(cval, ckeys, KEY_MAX))
    wk_vh = O.drop_set(wk_vh, lin, torch.where(cval, cvhead, -1))
    wk_keys, wk_vh = O.sort_rows(wk_keys, wk_vh)

    merged = gold_count + gcount
    split = g_is_real & (merged > L)
    lc = torch.where(split, (merged + 1) // 2, merged)
    # allocate new leaves for splits: (left, right) per split, in order
    sofs = O.cumsum32(split) - 1
    left_id = torch.where(split, store.n_alloc + 2 * sofs, ML)
    right_id = torch.where(split, left_id + 1, ML)

    colidx = O.arange32(2 * L, dev)[None, :]
    lmask = colidx < lc[:, None]
    shift = (colidx + lc[:, None]).clamp_max(2 * L - 1).long()
    rmask = colidx < (merged - lc)[:, None]
    lk = torch.where(lmask, wk_keys, KEY_MAX)[:, :L]
    lv = torch.where(lmask, wk_vh, -1)[:, :L]
    rk = torch.where(rmask, wk_keys.gather(1, shift), KEY_MAX)[:, :L]
    rv = torch.where(rmask, wk_vh.gather(1, shift), -1)[:, :L]

    # in-place rewrite (no split) to gleaf; split halves to left/right ids
    ip_leaf = torch.where(g_is_real & ~split, gleaf, ML)
    kb, cb = O.sinked(store.leaf_keys), O.sinked(store.leaf_count)
    for rows, k, v, c in ((ip_leaf, wk_keys[:, :L], wk_vh[:, :L], merged),
                          (left_id, lk, lv, lc),
                          (right_id, rk, rv, merged - lc)):
        O.put(kb, O.lin_rows(rows, ML, L), k)
        O.put(vh_buf, O.lin_rows(rows, ML, L), v)
        O.put(cb, O.lin_1d(rows, ML), c)
    tb = O.sinked(store.leaf_ts)
    O.put(tb, O.lin_1d(left_id, ML), base_ts)
    O.put(tb, O.lin_1d(right_id, ML), base_ts)
    # paper's split protocol bookkeeping: old leaf frozen, newNext -> left
    old_split_leaf = O.lin_1d(torch.where(split, gleaf, ML), ML)
    leaf_frozen = O.drop_set(store.leaf_frozen, old_split_leaf, True)
    leaf_newnext = O.drop_set(store.leaf_newnext, old_split_leaf, left_id)

    # ---- leaf_next delta: the left half takes the old leaf's chain
    # position, the right half links to the old successor — or to the
    # successor's left half when that leaf split too.
    old_nexts = store.leaf_next[gleaf]                    # pre-batch chain
    adj = torch.cat([gord[1:] == gord[:-1] + 1,
                     torch.zeros(1, dtype=torch.bool, device=dev)])
    nxt_split_adj = adj & O.ahead(split, False)
    nxt_left = O.ahead(left_id, ML)
    prev_split_adj = O.shifted(split, False) & O.shifted(adj, False)
    nb = O.sinked(store.leaf_next)
    O.put(nb, O.lin_1d(torch.where(split, left_id, ML), ML),
          torch.where(split, right_id, -1))
    rnext = torch.where(nxt_split_adj, nxt_left, old_nexts)
    O.put(nb, O.lin_1d(torch.where(split, right_id, ML), ML),
          torch.where(split, rnext, -1))
    pred_leaf = _I.leaf_at(store.index, (gord - 1).clamp_min(0))
    w_pred = torch.where(split & (gord > 0) & ~prev_split_adj, pred_leaf, ML)
    O.put(nb, O.lin_1d(w_pred, ML), torch.where(split, left_id, -1))

    # ---- index delta: one separator insert per split, bottom-up
    e1_key = wk_keys.gather(1, lc.clamp_max(2 * L - 1).long()[:, None])[:, 0]
    new_index, idx_oflow = _I.apply_split_delta(
        store.index, split, wk_keys[:, 0], gleaf, left_id, right_id, e1_key)
    return dict(
        leaf_keys=O.unsink(kb, store.leaf_keys.shape),
        leaf_vhead=leaf_vhead0,
        leaf_count=O.unsink(cb, store.leaf_count.shape),
        leaf_next=O.unsink(nb, store.leaf_next.shape),
        leaf_newnext=leaf_newnext, leaf_frozen=leaf_frozen,
        leaf_ts=O.unsink(tb, store.leaf_ts.shape),
        n_alloc=store.n_alloc + 2 * n_splits,
        index=new_index,
        n_leaves=store.n_leaves + n_splits,
        idx_oflow=idx_oflow,
    )


def derive_update_codes(keys, values) -> np.ndarray:
    """Op codes for the legacy (keys, values) update encoding: KEY_MAX key
    -> NOP, TOMBSTONE value -> DELETE, otherwise INSERT."""
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    return np.where(keys >= KEY_MAX, OP_NOP,
                    np.where(values == TOMBSTONE, OP_DELETE, OP_INSERT)
                    ).astype(np.int32)


# ---------------------------------------------------------------------------
# RANGEQUERY — the paper's single-interval bounded scan (scan_page)
# ---------------------------------------------------------------------------

def _last_ordinal(store: UruvStore) -> torch.Tensor:
    return (store.n_leaves - 1).clamp_min(0)


def range_query(store: UruvStore, k1, k2, snap_ts, *,
                max_scan_leaves: int = 64, max_results: int = 1024):
    """Snapshot range scan over exactly ``max_scan_leaves`` chained leaves
    from the leaf that may contain k1 (paper Sec 3.4 / Fig. 11).  Returns
    (keys[<=max_results], values, count, truncated); ``truncated`` means
    the window ended before k2."""
    cfg = store.cfg
    dev = store.device
    L = cfg.leaf_cap
    k1, k2, snap = (_i32(x, dev) for x in (k1, k2, snap_ts))
    bn1, bs1, _ = _I.descend(store.index, k1.reshape(1))
    lo = _I.leaf_ordinal(store.index, bn1, bs1)
    ppos = lo + O.arange32(max_scan_leaves, dev)
    pvalid = ppos < store.n_leaves
    ppos_c = torch.minimum(ppos, _last_ordinal(store))
    # a leaf participates if its separator <= k2 (first leaf always does)
    sep = torch.where(pvalid, _I.sep_at(store.index, ppos_c), KEY_MAX)
    pvalid = pvalid & ((sep <= k2) | (ppos == lo))
    lids = torch.where(pvalid, _I.leaf_at(store.index, ppos_c), 0)

    keys = store.leaf_keys[lids]                             # [S, L]
    slot_ok = O.arange32(L, dev)[None, :] < store.leaf_count[lids][:, None]
    kmask = pvalid[:, None] & slot_ok & (keys >= k1) & (keys <= k2)
    flat_vh = torch.where(kmask, store.leaf_vhead[lids], -1).reshape(-1)
    flat_keys = torch.where(kmask, keys, KEY_MAX).reshape(-1)
    vals = _resolve(store, flat_vh, snap)
    hit = (flat_keys < KEY_MAX) & (vals != NOT_FOUND)

    # compact hits to the front (sorted by key), take max_results
    sk, perm = torch.sort(torch.where(hit, flat_keys, KEY_MAX), stable=True)
    n_hit = hit.sum(dtype=I32)
    count = n_hit.clamp_max(max_results)
    out_keys = sk[:max_results]
    out_vals = torch.where(out_keys < KEY_MAX, vals[perm][:max_results],
                           NOT_FOUND)
    last_pos = lo + max_scan_leaves
    more_leaves = (last_pos < store.n_leaves) & (
        _I.sep_at(store.index, torch.minimum(last_pos, _last_ordinal(store)))
        <= k2)
    truncated = (more_leaves | (n_hit > max_results))[0]
    return out_keys, out_vals, count, truncated


# ---------------------------------------------------------------------------
# bulk_range — one pass over a whole announce array of range queries: a
# shared endpoint descent, one pooled (query, leaf) worklist, the fused
# gather + versioned resolve kernel, sort-free per-query compaction
# ---------------------------------------------------------------------------

def bulk_range(store: UruvStore, k1, k2, snap_ts, *, max_results: int = 1024,
               scan_leaves: int = 16, max_rounds: int = 8):
    """Batched snapshot range scan: Q intervals [k1, k2] (``k1 > k2`` is
    empty) at snapshots ``snap_ts`` (scalar or [Q]) in one pass with a
    pooled budget of ``Q * scan_leaves * max_rounds`` leaves.

    Returns ``(keys[Q, R], values[Q, R], count[Q], truncated[Q],
    resume_k1[Q])``, rows key-sorted and KEY_MAX / NOT_FOUND padded;
    a truncated query resumes exactly at ``resume_k1``.  Read-only."""
    cfg = store.cfg
    dev = store.device
    L = cfg.leaf_cap
    k1 = _i32(k1, dev)
    k2 = _i32(k2, dev)
    snap = _i32(snap_ts, dev).expand(k1.shape)
    Q = k1.shape[0]
    R = max_results
    T = Q * scan_leaves * max_rounds
    n_leaves = store.n_leaves

    # ---- shared index descent: rank k1 AND k2 of every query
    bn, bs, _ = _B.descend(store.index, torch.cat([k1, k2]))
    ords = _I.leaf_ordinal(store.index, bn, bs)
    lo = ords[:Q]
    hi = torch.minimum(torch.maximum(ords[Q:] + 1, lo + 1), n_leaves)
    # inverted intervals get a zero-width window (complete, never truncated)
    n_win = torch.where(k1 > k2, 0, (hi - lo).clamp_min(1))

    # ---- flat worklist: task t -> (query qid[t], leaf position ppos[t])
    offs = O.cumsum32(n_win) - n_win
    total = offs[Q - 1] + n_win[Q - 1]
    t = O.arange32(T, dev)
    qid = (_I.rank(offs, t, side="right") - 1).clamp(0, Q - 1)
    ppos = lo[qid] + (t - offs[qid])
    tvalid = (t < total) & (ppos < n_leaves)
    lids = torch.where(
        tvalid, _I.leaf_at(store.index,
                           torch.minimum(ppos, _last_ordinal(store))), 0)

    # ---- fused gather + in-interval mask + versioned resolve (kernel)
    cand_keys, cand_vals = _B.range_scan(
        lids[:, None], tvalid[:, None], k1[qid], k2[qid], snap[qid],
        store.leaf_keys, store.leaf_vhead, store.leaf_count,
        store.ver_ts, store.ver_next, store.ver_value,
        max_chain=cfg.max_chain)                          # [T, L]

    # ---- per-query compaction without sorting: the candidate stream is
    # already (query, key)-ordered, so a running hit count + binary
    # search recovers each query's r-th hit
    flat_keys = cand_keys.reshape(-1)
    N = T * L
    csum = O.cumsum32(flat_keys < KEY_MAX)
    n_hits_total = csum[N - 1]
    flat_start = offs.clamp_max(T) * L
    flat_end = (offs + n_win).clamp_max(T) * L
    hits_before = torch.where(flat_start > 0,
                              csum[(flat_start - 1).clamp_min(0)], 0)
    n_hit = torch.where(flat_end > flat_start,
                        csum[(flat_end - 1).clamp_min(0)] - hits_before, 0)
    count = n_hit.clamp_max(R)
    r = O.arange32(R, dev)[None, :]
    in_seg = r < count[:, None]
    idx = _I.rank(csum, torch.minimum(hits_before[:, None] + r + 1,
                                      n_hits_total), side="left")
    idxc = idx.clamp_max(N - 1)
    out_keys = torch.where(in_seg, flat_keys[idxc], KEY_MAX)
    out_vals = torch.where(in_seg, cand_vals.reshape(-1)[idxc], NOT_FOUND)

    # ---- truncation + resume (pagination contract)
    scanned = torch.minimum((T - offs).clamp_min(0), n_win)
    covered = scanned == n_win
    overflow = n_hit > R
    truncated = overflow | ~covered
    last_key = out_keys.gather(1, (count - 1).clamp_min(0).long()[:, None])[:, 0]
    unscanned_sep = torch.where(
        scanned > 0,
        _I.sep_at(store.index, torch.minimum(lo + scanned,
                                             _last_ordinal(store))),
        k1)
    resume_k1 = torch.where(overflow, last_key + 1,
                            torch.where(~covered, unscanned_sep, k2))
    return out_keys, out_vals, count, truncated, resume_k1


def scan_resume_sep(store: UruvStore, k1, max_scan_leaves: int, k2):
    """Separator of the first leaf past a ``max_scan_leaves`` window that
    starts at k1's leaf (or ``k2`` when the window reaches the end) — the
    zero-hit resume frontier of the bounded ``scan_page`` pass."""
    dev = store.device
    bn, bs, _ = _I.descend(store.index, _i32(k1, dev).reshape(1))
    end_pos = _I.leaf_ordinal(store.index, bn, bs) + max_scan_leaves
    return torch.where(
        end_pos < store.n_leaves,
        _I.sep_at(store.index, torch.minimum(end_pos, _last_ordinal(store))),
        _i32(k2, dev))[0]


# ---------------------------------------------------------------------------
# Snapshots + version tracker (paper Appendix E)
# ---------------------------------------------------------------------------

def snapshot(store: UruvStore) -> Tuple[UruvStore, torch.Tensor]:
    """RANGEQUERY LP: read the clock, register in the tracker ring (a free
    slot when one exists; a full ring evicts the cursor slot and flags
    ``OFLOW_TRACKER``).  Returns (store, snapshot ts)."""
    MT = store.cfg.tracker_cap
    free = ~store.trk_active
    lost = ~free.any()
    cur = torch.where(lost, store.trk_cursor % MT,
                      torch.argmax(free.to(I32)).to(I32)).long()
    trk_ts = store.trk_ts.clone()
    trk_ts[cur] = store.ts
    trk_active = store.trk_active.clone()
    trk_active[cur] = True
    new = dataclasses.replace(
        store, ts=store.ts + 1, trk_ts=trk_ts, trk_active=trk_active,
        trk_cursor=store.trk_cursor + 1,
        oflow=store.oflow | torch.where(lost, OFLOW_TRACKER, 0).to(I32))
    return new, store.ts


def release(store: UruvStore, snap_ts) -> UruvStore:
    """Release one active tracker entry registered at ``snap_ts``."""
    MT = store.cfg.tracker_cap
    match = store.trk_active & (store.trk_ts == _i32(snap_ts, store.device))
    idx = torch.where(match.any(), torch.argmax(match.to(I32)), MT)
    return dataclasses.replace(
        store, trk_active=O.drop_set(store.trk_active, O.lin_1d(idx, MT),
                                     False))


def min_active_ts(store: UruvStore) -> torch.Tensor:
    return torch.where(store.trk_active, store.trk_ts, store.ts).min()


# ---------------------------------------------------------------------------
# COMPACT — stop-the-world version GC + packed leaf rebuild
# ---------------------------------------------------------------------------

def compact(store: UruvStore) -> Tuple[UruvStore, torch.Tensor]:
    """Rebuild the store, reclaiming versions below min_active_ts.

    Per key it retains every version with ts > floor plus the one
    resolved at the floor, at most cfg.max_chain; fully dead keys go.
    Returns (new_store, n_live_keys)."""
    cfg = store.cfg
    dev = store.device
    L, ML, MV, D = cfg.leaf_cap, cfg.max_leaves, cfg.max_versions, cfg.max_chain
    floor = min_active_ts(store)

    # all live keys in index order -> flat [ML*L]
    allp = O.arange32(ML, dev)
    live_rows = allp < store.n_leaves
    order_leaf = torch.where(
        live_rows,
        _I.leaf_at(store.index, torch.minimum(allp, _last_ordinal(store))), 0)
    slot_ok = (O.arange32(L, dev)[None, :]
               < store.leaf_count[order_leaf][:, None])
    keep_slot = live_rows[:, None] & slot_ok
    keys = torch.where(keep_slot, store.leaf_keys[order_leaf],
                       KEY_MAX).reshape(-1)
    vhs = torch.where(keep_slot, store.leaf_vhead[order_leaf], -1).reshape(-1)
    N = keys.shape[0]

    # walk each chain up to depth D, collecting retained versions
    cur = vhs
    kept_n = torch.zeros(N, dtype=I32, device=dev)
    reached = torch.zeros(N, dtype=torch.bool, device=dev)
    kept_idx, kept_mask = [], []
    for _ in range(D):
        ok = cur >= 0
        safe = cur.clamp_min(0)
        keep_this = ok & ~reached
        kept_idx.append(torch.where(keep_this, cur, -1))
        kept_mask.append(keep_this)
        reached = reached | (ok & (store.ver_ts[safe] <= floor))
        kept_n = kept_n + keep_this.to(I32)
        cur = torch.where(ok, store.ver_next[safe], -1)
    kept_idx = torch.stack(kept_idx, 1)          # [N, D], newest-first
    kept_mask = torch.stack(kept_mask, 1)

    vh0 = vhs.clamp_min(0)
    head_val = torch.where(vhs >= 0, store.ver_value[vh0], NOT_FOUND)
    only_old_tomb = ((kept_n == 1) & (head_val == TOMBSTONE)
                     & (torch.where(vhs >= 0, store.ver_ts[vh0], 0) <= floor))
    live = (keys < KEY_MAX) & (kept_n > 0) & ~only_old_tomb

    # compact live keys to the front (already key-sorted in index order)
    corder = torch.sort(torch.where(live, 0, 1).to(I32), stable=True).indices
    ckeys = torch.where(live[corder], keys[corder], KEY_MAX)
    ckept_idx, ckept_mask = kept_idx[corder], kept_mask[corder]
    n_live = live.sum(dtype=I32)

    # rebuild the version pool: a new slot per retained version
    flat_keep = ckept_mask.reshape(-1)
    new_slot_flat = O.cumsum32(flat_keep) - 1
    new_slot = torch.where(ckept_mask, new_slot_flat.view(N, D), -1)
    src = ckept_idx.clamp_min(0).reshape(-1)
    dst = O.lin_1d(torch.where(flat_keep, new_slot_flat, MV), MV)
    zeros = torch.zeros(MV, dtype=I32, device=dev)
    ver_value = O.drop_set(zeros, dst, store.ver_value[src])
    ver_ts = O.drop_set(zeros, dst, store.ver_ts[src])
    # chain: version j links to version j+1 of the same key (newest-first)
    nxt_in_key = torch.cat(
        [new_slot[:, 1:], torch.full((N, 1), -1, dtype=I32, device=dev)],
        1).reshape(-1)
    ver_next = O.drop_set(torch.full((MV,), -1, dtype=I32, device=dev), dst,
                          nxt_in_key)

    # rebuild packed leaves at pack_fill occupancy
    F = cfg.pack_fill
    n_new_leaves = ((n_live + F - 1) // F).clamp_min(1)
    kidx = O.arange32(N, dev)
    lin = O.lin_elem(torch.where(kidx < n_live, kidx // F, ML), kidx % F,
                     ML, L)
    leaf_keys = O.drop_set(
        torch.full((ML, L), KEY_MAX, dtype=I32, device=dev), lin, ckeys)
    leaf_vhead = O.drop_set(
        torch.full((ML, L), -1, dtype=I32, device=dev), lin, new_slot[:, 0])
    leaf_count = torch.where(allp < n_new_leaves,
                             (n_live - allp * F).clamp(0, F), 0)
    leaf_next = torch.where(allp + 1 < n_new_leaves, allp + 1, -1)
    # a fresh packed index build; cumulative index counters survive
    sep_keys = torch.where(allp < n_new_leaves,
                           leaf_keys[allp.clamp_max(ML - 1), 0], KEY_MAX)
    sep_leaf = torch.where(allp < n_new_leaves, allp, -1)
    new_index = dataclasses.replace(
        _I.build(cfg.index_config(), ML, sep_keys, sep_leaf, n_new_leaves),
        stat_delta_passes=store.index.stat_delta_passes,
        stat_propagations=store.index.stat_propagations)

    new = dataclasses.replace(
        store,
        leaf_keys=leaf_keys, leaf_vhead=leaf_vhead, leaf_count=leaf_count,
        leaf_next=leaf_next,
        leaf_newnext=torch.full((ML,), -1, dtype=I32, device=dev),
        leaf_frozen=torch.zeros(ML, dtype=torch.bool, device=dev),
        leaf_ts=store.ts.expand(ML).clone(),
        n_alloc=n_new_leaves, index=new_index, n_leaves=n_new_leaves.clone(),
        ver_value=ver_value, ver_ts=ver_ts, ver_next=ver_next,
        n_vers=flat_keep.sum(dtype=I32),
        oflow=torch.zeros((), dtype=I32, device=dev),
    )
    return new, n_live


def reindex(store: UruvStore) -> UruvStore:
    """Stop-the-world index repack at pack_fill — the recovery path for
    ``OFLOW_INDEX``.  Leaves, versions, clock and tracker are untouched,
    so every result is byte-identical."""
    return dataclasses.replace(
        store,
        index=_I.reindex(store.index, store.n_leaves, store.cfg.max_leaves),
        oflow=torch.zeros_like(store.oflow))


# ---------------------------------------------------------------------------
# Introspection (host-side; tests)
# ---------------------------------------------------------------------------

def directory(store: UruvStore):
    """Host-side flat view of the index: (sep_keys, leaf_ids) numpy
    arrays of length n_leaves, in global key order."""
    return _I.directory(store.index, int(store.n_leaves))


def live_items(store: UruvStore):
    """All (key, latest non-tombstone value) pairs in key order."""
    _, dirl = directory(store)
    lk = store.leaf_keys.cpu().numpy()[dirl]
    lv = store.leaf_vhead.cpu().numpy()[dirl]
    lc = store.leaf_count.cpu().numpy()[dirl]
    mask = np.arange(lk.shape[1])[None, :] < lc[:, None]
    k, vh = lk[mask], lv[mask]
    k, vh = k[vh >= 0], vh[vh >= 0]
    v = store.ver_value.cpu().numpy()[vh]
    keep = v != TOMBSTONE
    return list(zip(k[keep].tolist(), v[keep].tolist()))


def check_invariants(store: UruvStore) -> None:
    """Paper Appendix B invariants + full index coherence (host-side):
    the fat-node index (:func:`repro_torch.core.index.check_index`),
    sorted unique leaves inside their separators, inter-leaf order, and a
    ``leaf_next`` chain that visits exactly the in-order leaf sequence."""
    nl = int(store.n_leaves)
    assert nl >= 1
    _I.check_index(store.index, nl)
    dirk, dirl = directory(store)
    assert dirk[0] == KEY_MIN
    assert np.all(np.diff(dirk.astype(np.int64)) > 0), "separators not sorted"
    lk = store.leaf_keys.cpu().numpy()[dirl].astype(np.int64)
    lc = store.leaf_count.cpu().numpy()[dirl]
    col = np.arange(lk.shape[1])[None, :]
    assert np.all(lk[col >= lc[:, None]] == KEY_MAX), "leaf padding violated"
    inside = col[:, 1:] < lc[:, None]
    assert np.all(np.diff(lk, axis=1)[inside] > 0), (
        "invariant 1: leaf not sorted/unique")
    has = lc > 0
    assert np.all(lk[1:, 0][has[1:]] >= dirk[1:][has[1:]]), (
        "leaf underflows its separator")
    firsts = lk[has, 0]
    lasts = lk[has, lc[has] - 1]
    assert np.all(firsts[1:] > lasts[:-1]), "invariant 2: inter-leaf order"
    # the chained leaf level must be EXACTLY the in-order leaf sequence
    nxt = store.leaf_next.cpu().numpy()
    chain = []
    cur = int(dirl[0])
    seen = set()
    while cur != -1 and cur not in seen and len(chain) <= nl:
        chain.append(cur)
        seen.add(cur)
        cur = int(nxt[cur])
    assert chain == dirl.tolist(), (
        f"leaf_next chain != leftmost-descent order: {chain} vs "
        f"{dirl.tolist()}")
