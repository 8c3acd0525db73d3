"""The multi-level fat-node internal index, in PyTorch.

A port of the JAX package's ``repro.core.index`` (DESIGN.md Sec 11):
level 0 is the bottom (fat nodes over the leaf separators, children are
leaf ids), level ``depth-1`` the root (always node 0).  Entries are
sorted in-node and KEY_MAX padded; an entry's key is a lower bound for
its subtree.  Structural batches apply a bounded separator delta
bottom-up (:func:`apply_split_delta`); an ordinal spine (``ord_node`` /
``node_pos`` / ``ord_start``) gives rank/select over the global leaf
order, and ``leaf_ent`` maps a leaf id back to its bottom entry.

Field names and every array match the JAX ``UruvIndex``; the per-level
tuples are lists of tensors here.  All functions are plain tensor code
on the index's device.  ``merge_deletable``, ``apply_merge_delta``,
``retarget_leaves`` and ``grow_to`` come with the port of
``core/lifecycle.py`` (ROADMAP).
"""

# uruvlint: disable-file=layering-index; reason: this IS the port's index module: rank/select over the spine is searchsorted by design (the JAX twin is the rule's allowed repro/core/index.py)

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import _ops as O
from repro_torch.core.ref import KEY_MAX, KEY_MIN

I32 = torch.int32
_I32MAX = KEY_MAX       # ord_start padding (keeps searchsorted monotone)


def pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Static index geometry derived from (max_leaves, index_fanout)."""

    fanout: int                 # F — entries per fat node
    depth: int                  # levels; level 0 bottom, depth-1 root
    caps: Tuple[int, ...]       # per-level node-pool capacity (pow2)

    @property
    def pack_fill(self) -> int:
        """Occupancy target for freshly built nodes (3F/4)."""
        return max(1, (3 * self.fanout) // 4)


@functools.lru_cache(maxsize=None)
def index_config(max_leaves: int, fanout: int) -> IndexConfig:
    """Depth/capacity model: level l holds the level-(l-1) node stream
    packed at >= F/2 fill, so caps shrink by F/2 per level until one root
    node covers everything."""
    if fanout < 4:
        raise ValueError(f"index_fanout must be >= 4, got {fanout}")
    half = fanout // 2
    caps = []
    n_entries = max(1, int(max_leaves))
    while True:
        n_nodes = -(-n_entries // half)
        caps.append(pow2ceil(n_nodes))
        if n_entries <= fanout:
            caps[-1] = max(caps[-1], 1)
            break
        n_entries = n_nodes
    return IndexConfig(fanout=fanout, depth=len(caps), caps=tuple(caps))


@dataclasses.dataclass
class UruvIndex:
    # --- levels (l = 0 bottom .. depth-1 root; root is node 0) ---
    node_keys: List[torch.Tensor]       # int32 [C_l, F] sorted, KEY_MAX pad
    node_child: List[torch.Tensor]      # int32 [C_l, F]; l=0: leaf ids
    node_cnt: List[torch.Tensor]        # int32 [C_l]; 0 == free slot
    # --- ordinal spine over the bottom level ---
    ord_node: torch.Tensor              # int32 [C0] ordinal -> node id; -1 pad
    node_pos: torch.Tensor              # int32 [C0] node id -> ordinal; -1 dead
    ord_start: torch.Tensor             # int32 [C0] first leaf ordinal; I32MAX pad
    n_nodes0: torch.Tensor              # int32 [] live bottom nodes
    # --- reverse map ---
    leaf_ent: torch.Tensor              # int32 [ML] leaf id -> node*F+slot; -1
    # --- observability (cumulative counters) ---
    stat_delta_passes: torch.Tensor     # int32 [] structural delta passes
    stat_propagations: torch.Tensor     # int32 [] node updates above level 0
    cfg: IndexConfig


# ---------------------------------------------------------------------------
# Build (packed) — create(), compact(), reindex()
# ---------------------------------------------------------------------------

def build(cfg: IndexConfig, max_leaves: int, sep_keys: torch.Tensor,
          sep_leaf: torch.Tensor, n_sep) -> UruvIndex:
    """Pack ``n_sep`` separators (key order, length ``max_leaves``;
    ``sep_keys[0]`` is forced to KEY_MIN) into fresh fat nodes at
    pack_fill occupancy.  O(ML); steady-state batches use the delta path."""
    F, D = cfg.fanout, cfg.depth
    PF = cfg.pack_fill
    ML = max_leaves
    dev = sep_keys.device
    n_sep = torch.as_tensor(n_sep, dtype=I32, device=dev)
    sep_keys = sep_keys.to(I32).clone()
    sep_keys[0] = KEY_MIN
    sep_leaf = sep_leaf.to(I32)

    keys_t, child_t, cnt_t = [], [], []
    # level 0: a depth-1 index IS its root, so everything packs into node 0
    PF0 = PF if D > 1 else F
    C0 = cfg.caps[0]
    i = O.arange32(ML, dev)
    valid = i < n_sep
    node = torch.where(valid, i // PF0, C0)
    slot = i % PF0
    lin = O.lin_elem(node, slot, C0, F)
    k0 = O.drop_set(torch.full((C0, F), KEY_MAX, dtype=I32, device=dev), lin,
                    torch.where(valid, sep_keys, KEY_MAX))
    c0 = O.drop_set(torch.full((C0, F), -1, dtype=I32, device=dev), lin,
                    torch.where(valid, sep_leaf, -1))
    n0 = ((n_sep + PF0 - 1) // PF0).clamp_min(1)
    o0 = O.arange32(C0, dev)
    cnt0 = (n_sep - o0 * PF0).clamp(0, PF0)
    cnt0 = torch.where(o0 < n0, cnt0, 0)
    cnt0[0] = cnt0[0].clamp_min(1)   # an empty store keeps its sentinel
    keys_t.append(k0)
    child_t.append(c0)
    cnt_t.append(cnt0)

    # upper levels: the previous level's node stream, packed
    n_prev = n0
    for l in range(1, D):
        Cp, Cl = cfg.caps[l - 1], cfg.caps[l]
        j = O.arange32(Cp, dev)
        v = j < n_prev
        ekey = torch.where(v, keys_t[l - 1][:, 0], KEY_MAX)
        pf = PF if l < D - 1 else F          # root swallows everything left
        lin = O.lin_elem(torch.where(v, j // pf, Cl), j % pf, Cl, F)
        kl = O.drop_set(torch.full((Cl, F), KEY_MAX, dtype=I32, device=dev),
                        lin, torch.where(v, ekey, KEY_MAX))
        cl = O.drop_set(torch.full((Cl, F), -1, dtype=I32, device=dev), lin,
                        torch.where(v, j, -1))
        nl = ((n_prev + pf - 1) // pf).clamp_min(1)
        ol = O.arange32(Cl, dev)
        cntl = torch.where(ol < nl, (n_prev - ol * pf).clamp(0, pf), 0)
        cntl[0] = cntl[0].clamp_min(1)
        keys_t.append(kl)
        child_t.append(cl)
        cnt_t.append(cntl)
        n_prev = nl

    live = o0 < n0
    leaf_ent = O.drop_set(
        torch.full((ML,), -1, dtype=I32, device=dev),
        O.lin_1d(torch.where(valid, sep_leaf, ML), ML),
        torch.where(valid, node * F + slot, -1))
    zero = torch.zeros((), dtype=I32, device=dev)
    return UruvIndex(
        node_keys=keys_t, node_child=child_t, node_cnt=cnt_t,
        ord_node=torch.where(live, o0, -1),
        node_pos=torch.where(live, o0, -1),
        ord_start=torch.where(live, o0 * PF0, _I32MAX),
        n_nodes0=n0.to(I32), leaf_ent=leaf_ent,
        stat_delta_passes=zero, stat_propagations=zero.clone(), cfg=cfg,
    )


# ---------------------------------------------------------------------------
# Descent (plain formulation; the CUDA twin is kernels/uruv_search)
# ---------------------------------------------------------------------------

def descend(idx: UruvIndex, queries: torch.Tensor):
    """Root->leaf F-way descent: (bnode, bslot, leaf) of the last
    separator <= q."""
    bnode, bslot, leaf, _, _ = _descend_full(idx, queries)
    return bnode, bslot, leaf


def descend_path(idx: UruvIndex, queries: torch.Tensor):
    """Full descent path: (nodes[D, P], slots[D, P]), level 0 first."""
    _, _, _, nodes, slots = _descend_full(idx, queries)
    return nodes, slots


def _descend_full(idx: UruvIndex, queries: torch.Tensor):
    D = idx.cfg.depth
    q = queries
    cur = torch.zeros_like(q)                    # root is node 0
    nodes, slots = [None] * D, [None] * D
    slot = nxt = cur
    for l in range(D - 1, -1, -1):
        r = O.jax_index(cur, idx.node_keys[l].shape[0])
        rows = idx.node_keys[l][r]               # [P, F]
        # live entries only: KEY_MAX is padding, never a separator
        cnt = ((rows <= q[:, None]) & (rows < KEY_MAX)).sum(1, dtype=I32)
        slot = (cnt - 1).clamp_min(0)
        nodes[l], slots[l] = cur, slot
        nxt = idx.node_child[l][r, slot]
        if l > 0:
            cur = nxt
    return nodes[0], slots[0], nxt, torch.stack(nodes), torch.stack(slots)


# ---------------------------------------------------------------------------
# Rank / select over the ordinal spine
# ---------------------------------------------------------------------------

def leaf_ordinal(idx: UruvIndex, bnode: torch.Tensor,
                 bslot: torch.Tensor) -> torch.Tensor:
    """Global leaf ordinal of a bottom (node, slot) entry."""
    C0 = idx.node_pos.shape[0]
    pos = idx.node_pos[bnode.clamp(0, C0 - 1)]
    return idx.ord_start[pos.clamp(0, C0 - 1)] + bslot


def rank_right(idx: UruvIndex, queries: torch.Tensor) -> torch.Tensor:
    """# separators <= q."""
    bnode, bslot, _ = descend(idx, queries)
    return leaf_ordinal(idx, bnode, bslot) + 1


def ord_locate(idx: UruvIndex, p: torch.Tensor):
    """Leaf ordinal -> (bottom node, slot); the caller masks p outside
    [0, n_leaves)."""
    C0 = idx.ord_start.shape[0]
    no = (rank(idx.ord_start, p, side="right") - 1).clamp(0, C0 - 1)
    node = idx.ord_node[no]
    slot = p - idx.ord_start[no]
    return node.clamp_min(0), slot.clamp(0, idx.cfg.fanout - 1)


def leaf_at(idx: UruvIndex, p: torch.Tensor) -> torch.Tensor:
    """Leaf id at ordinal p; the caller masks the range."""
    node, slot = ord_locate(idx, p)
    return idx.node_child[0][node, slot]


def sep_at(idx: UruvIndex, p: torch.Tensor) -> torch.Tensor:
    """Separator key at ordinal p; the caller masks the range."""
    node, slot = ord_locate(idx, p)
    return idx.node_keys[0][node, slot]


def rank(a: torch.Tensor, v: torch.Tensor, *, side: str = "right"
         ) -> torch.Tensor:
    """Sorted-array rank (int32) of ``v`` in ``a``."""
    return torch.searchsorted(a, v.contiguous(), right=(side == "right"),
                              out_int32=True)


# ---------------------------------------------------------------------------
# Delta application: bounded bottom-up separator inserts (leaf splits)
# with overflow-triggered node splits
# ---------------------------------------------------------------------------

def _insert_level(keys_l, child_l, cnt_l, it_node, it_key, it_child,
                  it_gidx, it_valid, *, fanout: int, is_root: bool):
    """Insert up to N (key, child) entries into level-l nodes.

    Returns (keys_l, child_l, cnt_l, seg, em_key, em_child, em_valid,
    oflow): ``seg`` describes each touched node's outcome, the ``em_*``
    are the entries a node split pushes to the parent level.  With no
    valid item this returns its inputs and an empty ``seg`` — exactly the
    reference's skip branch — so it runs unconditionally instead of
    syncing the host on "any item?" per level.
    """
    F = fanout
    Cl = keys_l.shape[0]
    N = it_node.shape[0]
    W = 2 * F
    dev = it_node.device
    posN = O.arange32(N, dev)

    # group items by target node: lexicographic (node, key) sort, packed
    # into one int64 key (key offset by 2**31 keeps its signed order)
    nodev = torch.where(it_valid, it_node, Cl)
    packed = nodev.long() * (1 << 32) + (it_key.long() + (1 << 31))
    order = torch.sort(packed, stable=True).indices
    snode, skey = nodev[order], it_key[order]
    schild, sgidx = it_child[order], it_gidx[order]
    svalid = snode < Cl
    first = svalid & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                snode[1:] != snode[:-1]])
    segid = O.cumsum32(first) - 1
    segstart = O.cummax(torch.where(first, posN, -1))
    off = posN - segstart.clamp_min(0)
    n_seg = first.sum(dtype=I32)
    seg_real = posN < n_seg
    srow = torch.where(first, segid, N - 1).long()
    seg_node = torch.zeros(N, dtype=I32, device=dev)
    seg_node[srow] = torch.where(first, snode, 0)
    seg_node = torch.where(seg_real, seg_node, 0)
    seg_gidx = torch.zeros(N, dtype=I32, device=dev)
    seg_gidx[srow] = torch.where(first, sgidx, 0)
    seg_ins = torch.zeros(N, dtype=I32, device=dev).index_add_(
        0, torch.where(svalid, segid, N - 1).long(), svalid.to(I32))

    # per-node workspace merge
    wk_keys = torch.full((N, W), KEY_MAX, dtype=I32, device=dev)
    wk_child = torch.full((N, W), -1, dtype=I32, device=dev)
    wk_keys[:, :F] = torch.where(seg_real[:, None], keys_l[seg_node], KEY_MAX)
    wk_child[:, :F] = torch.where(seg_real[:, None], child_l[seg_node], -1)
    lin = O.lin_elem(torch.where(svalid, segid, N - 1),
                     torch.where(svalid, F + off.clamp_max(F - 1), W), N, W)
    wk_keys = O.drop_set(wk_keys, lin, torch.where(svalid, skey, KEY_MAX))
    wk_child = O.drop_set(wk_child, lin, torch.where(svalid, schild, -1))
    wk_keys, wk_child = O.sort_rows(wk_keys, wk_child)

    old_cnt = torch.where(seg_real, cnt_l[seg_node], 0)
    new_cnt = old_cnt + seg_ins
    oflow = (seg_ins > F).any()              # structural bound violated

    # node splits on overflow
    ovf = seg_real & (new_cnt > F)
    lc = torch.where(ovf, (new_cnt + 1) // 2, new_cnt)
    free_cum = O.cumsum32(cnt_l == 0)
    n_free = free_cum[Cl - 1]
    ovfrank = O.cumsum32(ovf) - 1
    n_ovf = ovf.sum(dtype=I32)
    if is_root:
        oflow = oflow | (n_ovf > 0)          # the root may never split
    oflow = oflow | (n_ovf > n_free)
    # k-th free slot by binary search over the free-count prefix
    rid_k = rank(free_cum, ovfrank.clamp_max(N - 1) + 1, side="left")
    rid = torch.where(ovf, rid_k.clamp_max(Cl - 1), Cl)

    colW = O.arange32(W, dev)[None, :]
    lmask = colW < lc[:, None]
    lk = torch.where(lmask, wk_keys, KEY_MAX)[:, :F]
    lch = torch.where(lmask, wk_child, -1)[:, :F]
    shift = (colW + lc[:, None]).clamp_max(W - 1).long()
    rmask = colW < (new_cnt - lc)[:, None]
    rk = torch.where(rmask, wk_keys.gather(1, shift), KEY_MAX)[:, :F]
    rch = torch.where(rmask, wk_child.gather(1, shift), -1)[:, :F]

    wnode = torch.where(seg_real, seg_node, Cl)
    wrid = torch.where(ovf & ~oflow, rid, Cl)  # don't scribble when rejecting
    kb, cb, nb = O.sinked(keys_l), O.sinked(child_l), O.sinked(cnt_l)
    O.put(kb, O.lin_rows(wnode, Cl, F), lk)
    O.put(cb, O.lin_rows(wnode, Cl, F), lch)
    O.put(nb, O.lin_1d(wnode, Cl), lc)
    O.put(kb, O.lin_rows(wrid, Cl, F), rk)
    O.put(cb, O.lin_rows(wrid, Cl, F), rch)
    O.put(nb, O.lin_1d(wrid, Cl), new_cnt - lc)

    seg = dict(node=seg_node, gidx=seg_gidx, real=seg_real, ovf=ovf,
               rid=rid, lc=lc, new_cnt=new_cnt,
               lk=lk, lch=lch, rk=rk, rch=rch)
    return (O.unsink(kb, keys_l.shape), O.unsink(cb, child_l.shape),
            O.unsink(nb, cnt_l.shape), seg,
            rk[:, 0], rid, ovf & ~oflow, oflow)


def apply_split_delta(idx: UruvIndex, valid: torch.Tensor,
                      gkey: torch.Tensor, old_leaf: torch.Tensor,
                      left_id: torch.Tensor, right_id: torch.Tensor,
                      rkey: torch.Tensor):
    """Apply one structural batch's leaf-split delta.

    Per split group g (masked by ``valid``): leaf ``old_leaf[g]`` (whose
    range contains ``gkey[g]``) froze and split into (left_id, right_id)
    at separator ``rkey[g]`` — its bottom entry is retargeted to
    ``left_id`` and (rkey, right_id) is inserted, node splits propagating
    upward only on overflow.  Returns ``(index, oflow)``; on oflow (a
    0-d bool tensor) the caller rejects the whole batch.
    """
    cfg = idx.cfg
    F, D = cfg.fanout, cfg.depth
    C0 = cfg.caps[0]
    P = gkey.shape[0]
    ML = idx.leaf_ent.shape[0]
    dev = gkey.device
    path_nodes, path_slots = descend_path(idx, gkey)     # [D, P]
    bnode = torch.where(valid, path_nodes[0], C0)
    bslot = torch.where(valid, path_slots[0], F)

    keys_t = list(idx.node_keys)
    child_t = list(idx.node_child)
    cnt_t = list(idx.node_cnt)

    # level 0 entry retarget: old (frozen) leaf -> left half
    child_t[0] = O.drop_set(child_t[0], O.lin_elem(bnode, bslot, C0, F),
                            torch.where(valid, left_id, -1))
    ent_buf = O.sinked(idx.leaf_ent)
    O.put(ent_buf, O.lin_1d(torch.where(valid, old_leaf, ML), ML), -1)

    it_node = torch.where(valid, bnode, C0)
    it_key, it_child = rkey, right_id
    it_gidx = O.arange32(P, dev)
    it_valid = valid
    oflow = torch.zeros((), dtype=torch.bool, device=dev)
    seg0 = None
    props = torch.zeros((), dtype=I32, device=dev)
    for l in range(D):
        (keys_t[l], child_t[l], cnt_t[l], seg,
         em_key, em_child, em_valid, ofl) = _insert_level(
            keys_t[l], child_t[l], cnt_t[l],
            it_node, it_key, it_child, it_gidx, it_valid,
            fanout=F, is_root=(l == D - 1))
        oflow = oflow | ofl
        if l == 0:
            seg0 = seg
        else:
            props = props + it_valid.sum(dtype=I32)
        if l + 1 < D:
            # parent of a split level-l node = the descent path of any
            # item that targeted it (paths to a node are unique)
            parent = path_nodes[l + 1][seg["gidx"]]
            it_node = torch.where(em_valid, parent, cfg.caps[l + 1])
            it_key, it_child = em_key, em_child
            it_gidx = seg["gidx"]
            it_valid = em_valid

    # reverse map: rewrite leaf_ent for every touched bottom node
    sl = O.arange32(F, dev)[None, :]
    lmask = seg0["real"][:, None] & (sl < seg0["lc"][:, None])
    O.put(ent_buf, O.lin_1d(torch.where(lmask, seg0["lch"], ML), ML),
          torch.where(lmask, seg0["node"][:, None] * F + sl, -1))
    rmask = (seg0["ovf"] & ~oflow)[:, None] & (
        sl < (seg0["new_cnt"] - seg0["lc"])[:, None])
    O.put(ent_buf, O.lin_1d(torch.where(rmask, seg0["rch"], ML), ML),
          torch.where(rmask, seg0["rid"][:, None] * F + sl, -1))

    # spine refresh: insert split-off nodes after their left halves
    o = O.arange32(C0, dev)
    n0 = idx.n_nodes0 + seg0["ovf"].sum(dtype=I32)
    sp = torch.where(seg0["ovf"], idx.node_pos[seg0["node"]], _I32MAX)
    sps, perm = torch.sort(sp, stable=True)
    srids = seg0["rid"][perm]
    ins_newpos = torch.where(sps < _I32MAX, sps + O.arange32(P, dev) + 1,
                             _I32MAX)
    kk = rank(ins_newpos, o, side="right")
    kk1 = (kk - 1).clamp_min(0)
    is_ins = (kk > 0) & (ins_newpos[kk1] == o)
    src = (o - kk).clamp(0, C0 - 1)
    ord_node = torch.where(
        is_ins, srids[kk1],
        torch.where(o - kk < idx.n_nodes0, idx.ord_node[src], -1))
    ord_node = torch.where(o < n0, ord_node, -1)
    p_n = idx.node_pos
    shift = rank(sps, p_n.clamp_min(0), side="left")
    node_pos = torch.where(p_n >= 0, p_n + shift, -1)
    spc = sp.clamp_min(0)
    newpos_k = spc + rank(sps, spc, side="left") + 1
    node_pos = O.drop_set(
        node_pos, O.lin_1d(torch.where(seg0["ovf"], seg0["rid"], C0), C0),
        torch.where(seg0["ovf"], newpos_k, -1))
    ord_cnt = torch.where(o < n0, cnt_t[0][ord_node.clamp_min(0)], 0)
    ord_start = torch.where(o < n0, O.cumsum32(ord_cnt) - ord_cnt, _I32MAX)

    new = dataclasses.replace(
        idx,
        node_keys=keys_t, node_child=child_t, node_cnt=cnt_t,
        ord_node=ord_node, node_pos=node_pos, ord_start=ord_start,
        n_nodes0=n0, leaf_ent=O.unsink(ent_buf, idx.leaf_ent.shape),
        stat_delta_passes=idx.stat_delta_passes + 1,
        stat_propagations=idx.stat_propagations + props,
    )
    return new, oflow


# ---------------------------------------------------------------------------
# Reindex (stop-the-world repack)
# ---------------------------------------------------------------------------

def inorder(idx: UruvIndex, max_leaves: int):
    """(sep_keys[ML], sep_leaf[ML]) in global key order (garbage past
    n_leaves; callers mask) — the flat-directory view."""
    p = O.arange32(max_leaves, idx.ord_start.device)
    return sep_at(idx, p), leaf_at(idx, p)


def reindex(idx: UruvIndex, n_sep, max_leaves: int) -> UruvIndex:
    """Rebuild the index from its own in-order traversal, repacked at
    pack_fill — the recovery path for ``OFLOW_INDEX`` (fragmentation).
    Results are unchanged by construction; the counters carry over."""
    keys, leaves = inorder(idx, max_leaves)
    valid = O.arange32(max_leaves, keys.device) < n_sep
    new = build(idx.cfg, max_leaves, torch.where(valid, keys, KEY_MAX),
                torch.where(valid, leaves, -1), n_sep)
    return dataclasses.replace(new,
                               stat_delta_passes=idx.stat_delta_passes,
                               stat_propagations=idx.stat_propagations)


# ---------------------------------------------------------------------------
# Host-side introspection + invariants (tests, check_invariants)
# ---------------------------------------------------------------------------

def directory(idx: UruvIndex, n_sep: int):
    """Host-side flat view: (sep_keys[n_sep], sep_leaf[n_sep]) numpy."""
    keys, leaves = inorder(idx, idx.leaf_ent.shape[0])
    return keys.cpu().numpy()[:n_sep], leaves.cpu().numpy()[:n_sep]


def check_index(idx: UruvIndex, n_sep: int) -> None:
    """Full index verification (host-side):

      * per-level in-node sortedness + KEY_MAX padding + cnt coherence
      * child coverage: the root's in-order expansion visits every live
        node exactly once; entry keys are lower bounds of their subtree,
        separators strictly increasing globally
      * spine coherence: ord_node/node_pos inverse, ord_start exact
        prefix sums, n_nodes0 == live bottom nodes
      * reverse map: leaf_ent is the exact inverse of bottom child slots
    """
    cfg = idx.cfg
    F, D = cfg.fanout, cfg.depth
    keys = [k.cpu().numpy() for k in idx.node_keys]
    child = [c.cpu().numpy() for c in idx.node_child]
    cnts = [c.cpu().numpy() for c in idx.node_cnt]
    for l in range(D):
        k, c = keys[l], cnts[l]
        assert k.shape == (cfg.caps[l], F)
        assert np.all((c >= 0) & (c <= F)), f"bad node count at level {l}"
        col = np.arange(F)[None, :]
        assert np.all(k[col >= c[:, None]] == KEY_MAX), f"pad violated l{l}"
        inside = col[:, 1:] < c[:, None]
        d = np.diff(k.astype(np.int64), axis=1)
        assert np.all(d[inside] > 0), f"node not sorted at level {l}"

    # in-order expansion from the root
    def expand(l, n):
        cnt = int(cnts[l][n])
        assert cnt >= 1, f"empty live node l{l} n{n}"
        out = []
        for s in range(cnt):
            key = int(keys[l][n][s])
            ch = int(child[l][n][s])
            if l == 0:
                out.append((key, ch, n, s))
            else:
                sub = expand(l - 1, ch)
                assert sub[0][0] >= key, \
                    f"entry key not a lower bound l{l} n{n} s{s}"
                out.extend(sub)
        return out

    flat = expand(D - 1, 0)
    assert len(flat) == n_sep, (len(flat), n_sep)
    sk = np.array([e[0] for e in flat], np.int64)
    assert sk[0] == KEY_MIN, "left sentinel lost"
    assert np.all(np.diff(sk) > 0), "separators not strictly sorted"

    # spine
    bnodes = []
    for (_, _, n, _) in flat:
        if not bnodes or bnodes[-1] != n:
            bnodes.append(n)
    n0 = int(idx.n_nodes0)
    assert n0 == len(bnodes), (n0, len(bnodes))
    ordn = idx.ord_node.cpu().numpy()
    npos = idx.node_pos.cpu().numpy()
    osta = idx.ord_start.cpu().numpy()
    assert ordn[:n0].tolist() == bnodes, "ord_node order broken"
    assert np.all(ordn[n0:] == -1)
    start = 0
    for p, n in enumerate(bnodes):
        assert int(npos[n]) == p, "node_pos inverse broken"
        assert int(osta[p]) == start, (p, int(osta[p]), start)
        start += int(cnts[0][n])
    assert np.all(osta[n0:] == _I32MAX)

    # reverse map
    ent = idx.leaf_ent.cpu().numpy()
    want = np.full(ent.shape[0], -1, np.int64)
    for (_, leaf, n, s) in flat:
        want[leaf] = n * F + s
    assert np.array_equal(ent, want), "leaf_ent is not the inverse map"
