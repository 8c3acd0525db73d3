"""Collectives of the partitioned step, inferred from sharding specs.

The JAX package's dry run compiles each cell for 512 placeholder devices
and reads the collectives that XLA's SPMD partitioner put into the HLO.
The port has no partitioner: its dry run (``launch.dryrun``) executes the
step once on ``meta`` tensors.  :class:`SpecPass` rides that one trace
(``dryrun.StepCounter`` calls it for every aten op) and tags each tensor
with a spec for every production mesh at once, single 16x16 (data, model)
and multi 2x16x16 (pod, data, model), from:

  * parameters and AdamW's moments: ``sharding.param_shardings``;
  * the step's inputs: ``sharding.batch_specs``;
  * every ``ctx.shard_act`` point: the spec it constrains to (the pass
    listens on the ``ShardCtx``; ``shard_act`` still returns ``x``), and
    the same spec on the gradient that flows back through it, as JAX's
    ``with_sharding_constraint`` transposes;
  * a factory (``zeros``, ``arange``, ...): no layout yet, so the first
    op that reads it takes it in whatever layout it needs, at no cost.

Each op's rule derives its outputs' specs from its inputs' and names the
collectives the partitioned op needs (a spec is one tuple of mesh axes a
dim, as in ``sharding``; a merged dim remembers its parts, :class:`Fold`):

  pointwise    the most sharded full-size operand lays the output out;
               another operand sharded otherwise on a dim is all-gathered
               there, or all-to-all'd where its axis moves to another dim;
  contraction  (``mm``, ``bmm``; ``einsum`` and ``matmul`` lower to
               them) an axis on the contracted dim of both operands
               leaves a partial sum (unless gathering both operands
               moves fewer bytes): an **all-reduce** of the result, one
               for each contracted dim that is sharded (a weight gradient
               over (batch, sequence) rows: one over the batch axes, one
               over ``model``, as XLA's partitioner emits it).  An axis on
               a dim that one operand needs whole (an FSDP weight sharded
               on its input dim, an axis already splitting the other
               operand's rows) is all-gathered on the cheaper side; an
               axis on one operand's contracted dim alone is gathered
               there, or the other operand is sliced and the partial
               result all-reduced, whichever moves fewer bytes.  A
               partial sum is reduced where it is first needed whole: it
               stays pending (:class:`Partial`) through ops linear in it
               that hold no more bytes a chip (views, casts down, sums,
               adds of partial sums, products with whole operands), so a
               Python loop's per-step gradient contributions (the
               sLSTM's recurrent weight) accumulate before one reduction,
               as a scan's carry does in XLA; a step's partial outputs
               are reduced at its end (:meth:`SpecPass.finish`);
  reduction    over a sharded dim: an all-reduce of the result;
  sort / scan  (``sort``, ``topk``, ``cumsum``, ``cummax``) along a
               sharded dim, a pad or a concatenation of one: an
               all-gather of the operand there; a row or slice of one
               (``select``, ``slice``): an all-gather of its own bytes;
  gather       rows (``index``) from a table sharded on the gathered dim:
               each chip fetches the rows of the result it holds, an
               **all-to-all** of its result (the MoE dispatch and
               combine).  The rows follow the indices' layout; where every
               chip holds the indices, the result is PENDING: its first
               consumer lays it out (an expert product, a constraint) and
               the all-to-all is counted there.  An ``embedding`` or
               ``gather`` from such a table: a masked local lookup and an
               all-reduce of the result, as XLA resolves the token
               embedding; the table's gradient moves the token axes onto
               the feature dim (an all-to-all) where that is cheaper than
               all-reducing the whole table.  A scatter whose indices are
               sharded where its target is not: an all-reduce of the
               target;
  attention    the kernels' shape-only operators (``kernels._meta``)
               take q as it is and k, v in q's batch and head layout with
               their sequence whole: a sequence-sharded k, v is gathered;
               with heads on ``model`` no collective runs inside.  The
               backward all-reduces dk, dv over the axes that split q's
               rows (each chip then keeps its block of k's and v's own
               layout); decode over a sequence-sharded cache all-reduces
               its partial outputs;
  shard_act    a change of spec: an all-gather (an axis leaves), an
               all-to-all (an axis moves between dims) or a local slice
               (nothing).

An op the pass has no rule for gathers its sharded inputs and replicates
its outputs (counted in :attr:`SpecPass.unruled`; no dry-run cell has
one).

**What is counted.**  Bytes follow the JAX dry run's convention: each
collective's per-chip *result* bytes times ``WIRE_FACTOR`` (2 for an
all-reduce), in the dtype the step holds the tensor in where the
collective runs (bf16 for the weights the models cast before use; the
JAX record moves them in fp32, which XLA's CPU backend computes in).
Counts are executed counts: the trace runs every loop trip, the remat
recomputation and zamba's shared block where it runs, so a layer's
collectives count once a layer.  **Gradient reductions are named as the
JAX-compiled program has them: all-reduce.**  XLA's CPU partitioner
emits no ``reduce-scatter`` in any train cell's HLO (the weight
gradients are all-reduced whole, then sliced); the pass reduces every
partial sum, the gradients' included, by all-reduce, and counts no
``reduce-scatter``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

WIRE_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

ATTR = "_spmd_specs"     # a tensor's tag: a spec per mesh, FREE or PENDING
FREE = "free"            # made by a factory: takes any layout for nothing
PENDING = "pending"      # rows fetched on demand: takes the layout its
                         # first consumer needs, for an all-to-all
_aten = torch.ops.aten


class Fold(tuple):
    """A dim merged from several (a view): its axes, major first, as a
    plain entry, and ``parts`` ((size, axes) of each merged dim), so that
    splitting it back restores the merged dims' specs."""

    def __new__(cls, parts):
        obj = super().__new__(cls, tuple(a for _, e in parts for a in e))
        obj.parts = tuple(parts)
        return obj

    # a memo key tells a Fold from the plain entry of the same axes
    def __eq__(self, other):
        return type(other) is Fold and self.parts == other.parts

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(("F", self.parts))


class Partial(tuple):
    """A spec's last item where the tensor is a partial sum: the groups
    of mesh axes (one tuple a group, each reduced by one all-reduce) its
    chips' values are still to be summed over."""

    def __eq__(self, other):
        return type(other) is Partial and tuple.__eq__(self, other)

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(("P", tuple(self)))


def norm(spec, ndim: int) -> Tuple:
    """A ``sharding.Spec`` (None | axis | tuple of axes a dim, possibly
    shorter than the tensor) as one tuple of axes per dim."""
    out = []
    for d in range(ndim):
        e = spec[d] if spec is not None and d < len(spec) else None
        out.append(() if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)))
    return tuple(out)


def _axes(spec) -> set:
    return {a for e in spec for a in e}


def _without(spec, axes) -> Tuple:
    """``spec`` with ``axes`` removed (an entry that loses none keeps its
    :class:`Fold`)."""
    return tuple(e if not (set(e) & axes) else
                 tuple(a for a in e if a not in axes) for e in spec)


class _Mesh:
    """One mesh's view of the pass: its axis sizes, and the events (type,
    bytes) of the op being ruled."""

    def __init__(self, index: int, sizes: Dict[str, int], units):
        self.i = index
        self.sizes = sizes
        self.units = units          # the axis groups a layout assigns
        self.ev: List[Tuple[str, float]] = []
        self.fixed: Dict[int, Tuple] = {}   # id -> spec of a resolved
                                            # PENDING or partial tensor

    def spec(self, t: torch.Tensor) -> Tuple:
        """``t``'s spec on this mesh (a partial sum's without its
        marker)."""
        fixed = self.fixed.get(id(t))
        if fixed is not None:
            return fixed
        tag = getattr(t, ATTR, None)
        if tag is None or tag is FREE or tag is PENDING:
            return ((),) * t.dim()
        return _strip(tag[self.i])

    def partial(self, t: torch.Tensor) -> Optional[Partial]:
        tag = getattr(t, ATTR, None)
        if type(tag) is not tuple or id(t) in self.fixed:
            return None
        s = tag[self.i]
        return s[-1] if s and type(s[-1]) is Partial else None

    def reduce(self, t: torch.Tensor) -> None:
        """All-reduce a partial sum where it is needed whole: one
        all-reduce of its per-chip bytes a group of its marker."""
        spec, groups = self.spec(t), self.partial(t)
        for _ in groups:
            self.emit("all-reduce", self.local(t, spec))
        self.fixed[id(t)] = spec

    def pending(self, t: torch.Tensor) -> bool:
        return getattr(t, ATTR, None) is PENDING and id(t) not in self.fixed

    def resolve(self, t: torch.Tensor, spec) -> None:
        """Lay a PENDING tensor out by ``spec``: the all-to-all that
        fetches its rows there."""
        self.fixed[id(t)] = tuple(spec)
        self.emit("all-to-all", self.local(t, spec))

    def default(self, t: torch.Tensor, used=()) -> Tuple:
        """The layout of a tensor no operand constrains: each unit of
        mesh axes (the batch axes, then ``model``) not in ``used`` on the
        first dim it divides."""
        spec = [()] * t.dim()
        for unit in self.units:
            if set(unit) & set(used):
                continue
            n = self.split((unit,))
            for d in range(t.dim()):
                if (t.shape[d] // self.split((spec[d],))) % n == 0 \
                        and t.shape[d] >= n * self.split((spec[d],)):
                    spec[d] = tuple(spec[d]) + tuple(unit)
                    break
        return tuple(spec)

    def split(self, spec) -> int:
        n = 1
        for e in spec:
            for a in e:
                n *= self.sizes[a]
        return n

    def local(self, t: torch.Tensor, spec) -> float:
        """Per-chip bytes of ``t`` laid out by ``spec``."""
        return t.numel() * t.element_size() / self.split(spec)

    def emit(self, kind: str, nbytes: float) -> None:
        if nbytes > 0:
            self.ev.append((kind, nbytes * WIRE_FACTOR[kind]))

    def move(self, t: torch.Tensor, cur, tgt) -> None:
        """Collectives that take ``t`` from ``cur`` to ``tgt`` (aligned,
        one entry a dim): an axis that leaves a dim for none is gathered,
        one that moves to another dim is all-to-all'd; an axis that
        appears is a local slice."""
        into = _axes(tgt)
        gathered, moved = set(), False
        for c, g in zip(cur, tgt):
            for a in c:
                if a not in g:
                    if a in into:
                        moved = True
                    else:
                        gathered.add(a)
        if not gathered and not moved:
            return
        kept = _without(cur, gathered)
        nbytes = self.local(t, kept)
        if gathered:
            self.emit("all-gather", nbytes)
        if moved:
            self.emit("all-to-all", nbytes)


# ---------------------------------------------------------------------------
# rules: (mesh, func, args, kwargs, tensor inputs, outputs) -> out specs
# ---------------------------------------------------------------------------

def _same(m, func, args, kwargs, ins, outs):
    return [m.spec(args[0])] * len(outs)


def _pointwise(m, func, args, kwargs, ins, outs):
    out = outs[0]
    nd, oshape = out.dim(), tuple(out.shape)
    opnds, lazy = [], []
    for t in ins:
        if getattr(t, ATTR, None) is FREE or t.dim() > nd:
            continue
        if m.pending(t):
            lazy.append(t)
            continue
        pad = nd - t.dim()
        opnds.append((t, ((),) * pad + tuple(m.spec(t)),
                      (1,) * pad + tuple(t.shape)))
    if not any(_axes(s) for _, s, _ in opnds):
        if lazy:                # replicated operands slice to any layout
            return [PENDING] * len(outs)
        if not opnds:
            return [FREE] * len(outs)
    full = [o for o in opnds if o[2] == oshape] or opnds
    prim = min(full, key=lambda o: o[0].numel() / m.split(o[1]))
    spec = [e if s == n else () for e, s, n in zip(prim[1], prim[2],
                                                      oshape)]
    used = _axes(spec)
    for t, s, shp in opnds:              # fill dims the primary broadcasts
        for d in range(nd):
            if (not spec[d] and s[d] and shp[d] == oshape[d]
                    and not set(s[d]) & used):
                spec[d] = s[d]
                used |= set(s[d])
    spec = tuple(spec)
    for t, s, shp in opnds:
        if t is not prim[0]:
            m.move(t, s, tuple(e if shp[d] == oshape[d] else ()
                               for d, e in enumerate(spec)))
    for t in lazy:
        pad = nd - t.dim()
        m.resolve(t, tuple(e if t.shape[d - pad] == oshape[d] else ()
                           for d, e in enumerate(spec) if d >= pad))
    return [spec if o.dim() == nd else ((),) * o.dim() for o in outs]


def _copy_(m, func, args, kwargs, ins, outs):
    dst, src = args[0], args[1]
    if getattr(dst, ATTR, None) is FREE:
        if src.shape == dst.shape:
            return [m.spec(src)]
        return [FREE]
    if m.pending(src) and src.shape == dst.shape:
        m.resolve(src, m.spec(dst))
    elif getattr(src, ATTR, None) is not FREE:
        pad = dst.dim() - src.dim()
        s = ((),) * pad + tuple(m.spec(src))
        shp = (1,) * pad + tuple(src.shape)
        m.move(src, s, tuple(e if shp[d] == dst.shape[d] else ()
                             for d, e in enumerate(m.spec(dst))))
    return [m.spec(dst)]


def _like(m, func, args, kwargs, ins, outs):
    if m.pending(args[0]):                # no rows to fetch: a factory's
        return [FREE] * len(outs)
    return [m.spec(args[0])]


def _factory(m, func, args, kwargs, ins, outs):
    return [FREE] * len(outs)


# ---- views -----------------------------------------------------------------

def _permute(m, func, args, kwargs, ins, outs):
    s, nd = m.spec(args[0]), args[0].dim()
    return [tuple(s[d % nd] for d in args[1])]


def _transpose(m, func, args, kwargs, ins, outs):
    s = list(m.spec(args[0]))
    if func is _aten.t.default:
        d0, d1 = 0, len(s) - 1
    else:
        d0, d1 = args[1] % len(s), args[2] % len(s)
    s[d0], s[d1] = s[d1], s[d0]
    return [tuple(s)]


def _unsqueeze(m, func, args, kwargs, ins, outs):
    s = list(m.spec(args[0]))
    s.insert(args[1] % (len(s) + 1), ())
    return [tuple(s)]


def _squeeze(m, func, args, kwargs, ins, outs):
    x = args[0]
    if len(args) > 1:
        dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        gone = {d % x.dim() for d in dims if x.shape[d] == 1}
    else:
        gone = {d for d in range(x.dim()) if x.shape[d] == 1}
    return [tuple(e for d, e in enumerate(m.spec(x)) if d not in gone)]


def _drop_dim(m, x, dim, out):
    """``x``'s spec without ``dim`` (a row of it taken, ``out``); a row
    of a sharded dim is all-gathered from its shard (the row's bytes: a
    loop over the rows gathers the tensor once)."""
    s = m.spec(x)
    dim %= x.dim()
    rest = s[:dim] + s[dim + 1:]
    if s[dim]:
        rest = _without(rest, set(s[dim]))
        m.emit("all-gather", m.local(out, rest))
    return rest


def _select(m, func, args, kwargs, ins, outs):
    return [_drop_dim(m, args[0], args[1], outs[0])]


def _unbind(m, func, args, kwargs, ins, outs):
    dim = args[1] if len(args) > 1 else 0
    return [_drop_dim(m, args[0], dim, o) for o in outs]


def _slice(m, func, args, kwargs, ins, outs):
    x = args[0]
    dim = (args[1] if len(args) > 1 else 0) % x.dim()
    s = m.spec(x)
    if outs[0].shape[dim] == x.shape[dim] or not s[dim]:
        return [s]
    whole = _without(s, set(s[dim]))
    m.emit("all-gather", m.local(outs[0], whole))    # the slice's bytes
    return [whole]


def _expand(m, func, args, kwargs, ins, outs):
    x, out = args[0], outs[0]
    pad = out.dim() - x.dim()
    s = m.spec(x)
    return [((),) * pad + tuple(
        () if x.shape[d] == 1 and out.shape[d + pad] != 1 else s[d]
        for d in range(x.dim()))]


def _entry(group) -> Tuple:
    """The entry of a dim made of ``group``'s (size, axes) parts: plain
    where only the first part is sharded (a tiled layout), else a
    :class:`Fold`."""
    group = [p for p in group if p[0] != 1]
    if not group:
        return ()
    if len(group) == 1 or not any(e for _, e in group[1:]):
        return tuple(group[0][1])
    return Fold(group)


def _reshape(m, func, args, kwargs, ins, outs):
    x, out = args[0], outs[0]
    old, new = tuple(x.shape), tuple(out.shape)
    s = m.spec(x)
    if not any(s):
        return [((),) * len(new)]
    if 0 in old:
        return [((),) * len(new)]
    oi = [d for d in range(len(old)) if old[d] != 1]
    ni = [d for d in range(len(new)) if new[d] != 1]
    res = [()] * len(new)
    lost = set()
    a = b = 0
    while a < len(oi) and b < len(ni):
        ga, gb = [oi[a]], [ni[b]]
        po, pn = old[oi[a]], new[ni[b]]
        while po != pn:
            if po < pn:
                a += 1
                ga.append(oi[a])
                po *= old[oi[a]]
            else:
                b += 1
                gb.append(ni[b])
                pn *= new[ni[b]]
        a += 1
        b += 1
        if len(ga) == 1 and len(gb) == 1:
            res[gb[0]] = s[ga[0]]
            continue
        parts = []
        for d in ga:
            e = s[d]
            parts.extend(e.parts if isinstance(e, Fold) else [(old[d], e)])
        parts = [p for p in parts if p[0] != 1]
        if len(gb) == 1:
            res[gb[0]] = _entry(parts)
            continue
        # split: restore the parts where their sizes line up with the new
        # dims, else place the axes greedily, major dim first
        k, ok, placed = 0, True, {}
        for d in gb:
            grp, p = [], 1
            while k < len(parts) and p < new[d]:
                grp.append(parts[k])
                p *= parts[k][0]
                k += 1
            if p != new[d]:
                ok = False
                break
            placed[d] = _entry(grp)
        if ok and k == len(parts):
            for d, e in placed.items():
                res[d] = e
            continue
        j, used = 0, 1
        for ax in (ax for _, e in parts for ax in e):
            while j < len(gb) and new[gb[j]] % (used * m.sizes[ax]):
                j, used = j + 1, 1
            if j == len(gb):
                lost.add(ax)
                continue
            res[gb[j]] = tuple(res[gb[j]]) + (ax,)
            used *= m.sizes[ax]
    if lost:
        m.emit("all-gather", m.local(x, _without(s, lost)))
    return [tuple(res)]


# ---- contractions ------------------------------------------------------------

def _contract(m, a, la, b, lb, lo, out):
    """Output spec of a contraction of ``a`` (dim labels ``la``) and ``b``
    (``lb``) into labels ``lo``, and its collectives (module docstring)."""
    for x, lx, y, ly in ((a, la, b, lb), (b, lb, a, la)):
        if m.pending(x):
            sy = m.spec(y)
            spec = [sy[ly.index(lab)] if lab in ly else () for lab in lx]
            used = _axes(spec)
            free = [d for d, lab in enumerate(lx) if lab not in ly]
            for unit in m.units:
                if set(unit) & used:
                    continue
                for d in free:
                    if x.shape[d] % (m.split((spec[d],))
                                     * m.split((unit,))) == 0:
                        spec[d] = tuple(spec[d]) + tuple(unit)
                        used |= set(unit)
                        break
            m.resolve(x, spec)
    sa, sb = m.spec(a), m.spec(b)
    where_a = {ax: d for d, e in enumerate(sa) for ax in e}
    where_b = {ax: d for d, e in enumerate(sb) for ax in e}
    free = {ax for d, ax_e in enumerate(sa) if la[d] in lo for ax in ax_e}
    free |= {ax for d, ax_e in enumerate(sb) if lb[d] in lo for ax in ax_e}
    out_local = out.numel() * out.element_size()
    for ax in free:
        out_local /= m.sizes[ax]
    ga, gb, partial = set(), set(), set()

    def gather_cost(t, s, done, ax):
        return m.local(t, _without(s, done | {ax}))

    def alone(lab, t, s, done, ax):
        """(cost, action) of ``ax`` on one operand only, at ``lab``."""
        if lab in lo:
            return 0.0, "keep"
        g = gather_cost(t, s, done, ax)
        r = 2 * out_local
        return (g, "gather") if g <= r else (r, "partial")

    for ax in list(where_a) + [x for x in where_b if x not in where_a]:
        da, db = where_a.get(ax), where_b.get(ax)
        lab_a = la[da] if da is not None else None
        lab_b = lb[db] if db is not None else None
        if lab_a is not None and lab_a == lab_b:
            if lab_a not in lo:           # reduce the result, or gather both
                both = (gather_cost(a, sa, ga, ax)
                        + gather_cost(b, sb, gb, ax))
                if both < 2 * out_local:
                    ga.add(ax)
                    gb.add(ax)
                else:
                    partial.add(ax)
            continue
        if lab_b is None:
            _, act = alone(lab_a, a, sa, ga, ax)
            (ga if act == "gather" else partial if act == "partial"
             else set()).add(ax)
            continue
        if lab_a is None:
            _, act = alone(lab_b, b, sb, gb, ax)
            (gb if act == "gather" else partial if act == "partial"
             else set()).add(ax)
            continue
        ca, acta = alone(lab_b, b, sb, gb, ax)    # gather a's, b keeps it
        ca += gather_cost(a, sa, ga, ax)
        cb, actb = alone(lab_a, a, sa, ga, ax)    # gather b's, a keeps it
        cb += gather_cost(b, sb, gb, ax)
        if ca <= cb:
            ga.add(ax)
            (gb if acta == "gather" else partial if acta == "partial"
             else set()).add(ax)
        else:
            gb.add(ax)
            (ga if actb == "gather" else partial if actb == "partial"
             else set()).add(ax)
    if ga:
        m.emit("all-gather", m.local(a, _without(sa, ga)))
    if gb:
        m.emit("all-gather", m.local(b, _without(sb, gb)))
    drop_a, drop_b = ga | partial, gb | partial
    spec = []
    for lab in lo:
        e = ()
        if lab in la:
            ea = sa[la.index(lab)]
            e = ea if not set(ea) & drop_a else _without((ea,), drop_a)[0]
        if lab in lb:
            eb = sb[lb.index(lab)]
            extra = tuple(x for x in eb if x not in drop_b and x not in e)
            if extra:
                e = tuple(e) + extra if e else (
                    eb if not set(eb) & drop_b else extra)
        spec.append(e)
    spec = tuple(spec)
    if partial:
        return spec + (Partial(tuple(sorted(g)) for g in _groups(
            partial, (sa, la), (sb, lb), lo)),)
    return spec


def _groups(partial: set, *operands_lo) -> List[set]:
    """``partial`` split into the groups reduced one at a time: the axes
    that shard one contracted dim of an operand (a merged dim, each of its
    parts), as XLA's partitioner reduces a partial sum once per sharded
    contracted dim (a weight gradient over the (batch, sequence) rows: an
    all-reduce over the data axes, another over ``model``)."""
    *operands, lo = operands_lo
    groups, seen = [], set()
    for spec, labels in operands:
        for d, lab in enumerate(labels):
            if lab in lo:
                continue
            e = spec[d]
            for part in (e.parts if isinstance(e, Fold) else [(0, e)]):
                g = (set(part[1]) & partial) - seen
                if g:
                    groups.append(g)
                    seen |= g
    if partial - seen:
        groups.append(partial - seen)
    return groups


def _mm(m, func, args, kwargs, ins, outs):
    return [_contract(m, args[0], "mk", args[1], "kn", "mn", outs[0])]


def _bmm(m, func, args, kwargs, ins, outs):
    return [_contract(m, args[0], "bmk", args[1], "bkn", "bmn", outs[0])]


# ---- reductions, scans ------------------------------------------------------

def _dims_arg(x, dims) -> set:
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return set(range(x.dim()))
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return {d % max(x.dim(), 1) for d in dims}


def _reduce(m, func, args, kwargs, ins, outs):
    x = args[0]
    name = func.overloadpacket.__name__
    if func in (_aten.sum.default, _aten.mean.default):
        dims, keep = None, False
    elif name == "var":
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = kwargs.get("keepdim", False)
    else:
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    red = _dims_arg(x, dims)
    s = m.spec(x)
    axes = {a for d in red for a in s[d]}
    spec = tuple(() if d in red else e for d, e in enumerate(s)
                 if keep or d not in red)
    outs_specs = [spec if o.dim() == len(spec) else ((),) * o.dim()
                  for o in outs]
    if axes:
        m.emit("all-reduce", m.local(outs[0], outs_specs[0]))
    return outs_specs


def _softmax(m, func, args, kwargs, ins, outs):
    x = args[0]
    if func is _aten._softmax_backward_data.default:
        dim = args[2] % x.dim()
        spec = _pointwise(m, func, args, kwargs, ins[:2], outs)[0]
        stats = 1
    else:
        dim = args[1] % x.dim()
        spec = m.spec(x)
        stats = 2                          # the max and the sum
    if spec not in (FREE, PENDING) and spec[dim]:
        row = m.local(outs[0], spec) / (x.shape[dim] / m.split((spec[dim],)))
        for _ in range(stats):
            m.emit("all-reduce", row)
    return [spec] * len(outs)


def _scan_dim(func, args, kwargs) -> int:
    name = func.overloadpacket.__name__
    if "dim" in kwargs:
        return kwargs["dim"]
    pos = 2 if name == "topk" else 1
    if name == "sort" and func._overloadname == "stable":
        return -1
    return args[pos] if len(args) > pos else (
        0 if name in ("cumsum", "cummax") else -1)


def _scan(m, func, args, kwargs, ins, outs):
    x = args[0]
    dim = _scan_dim(func, args, kwargs) % x.dim()
    s = m.spec(x)
    if s[dim]:
        s = _without(s, set(s[dim]))
        m.emit("all-gather", m.local(x, s))
    return [s] * len(outs)


# ---- gathers, scatters, joins ----------------------------------------------

def _embedding(m, func, args, kwargs, ins, outs):
    w, idx = args[0], args[1]
    sw, si = m.spec(w), m.spec(idx)
    clash = set(sw[1]) & _axes(si)
    if clash:
        m.emit("all-gather", m.local(w, _without(sw, clash)))
    rest = (tuple(a for a in sw[1] if a not in clash),)
    spec = tuple(si) + rest
    if sw[0]:
        m.emit("all-reduce", m.local(outs[0], spec))
    return [spec]


def _embedding_bwd(m, func, args, kwargs, ins, outs):
    """The table's gradient sums every token's row: a partial sum over
    the axes that shard the tokens.  Where the feature dim is free, the
    cheaper of reducing the whole table, and first moving token axes onto
    the feature dim (an all-to-all of the gradient) so that each chip
    reduces only its columns."""
    g = args[0]
    sg = m.spec(g)
    tok = _axes(sg[:-1])
    if not tok:
        return [((), sg[-1])]
    whole = 2 * m.local(outs[0], ((), sg[-1]))
    movable, n = [], g.shape[-1] // m.split((sg[-1],))
    for a in sorted(tok, key=lambda a: -m.sizes[a]):
        if n % m.sizes[a] == 0:
            movable.append(a)
            n //= m.sizes[a]
    moved = ((), tuple(sg[-1]) + tuple(movable))
    cost = m.local(g, sg) + 2 * m.local(outs[0], moved)
    if movable and cost < whole:
        m.emit("all-to-all", m.local(g, sg))
        if tok - set(movable):
            m.emit("all-reduce", m.local(outs[0], moved))
        return [moved]
    m.emit("all-reduce", m.local(outs[0], ((), sg[-1])))
    return [((), sg[-1])]


def _index(m, func, args, kwargs, ins, outs):
    x, indices = args[0], args[1]
    live = [(d, t) for d, t in enumerate(indices) if t is not None]
    sx = m.spec(x)
    if len(live) != 1 or live[0][0] != 0 or x.dim() == 0:
        if _axes(sx):
            m.emit("all-gather", x.numel() * x.element_size())
        return [((),) * outs[0].dim()]
    idx = live[0][1]
    si = m.spec(idx)
    rest = _without(sx[1:], _axes(si))
    if sx[0] and not _axes(si) and not _axes(rest):
        return [PENDING]         # each chip fetches the rows it will hold
    if _axes(sx[1:]) - _axes(rest):
        m.emit("all-gather", m.local(x, (sx[0],) + rest))
    spec = tuple(si) + tuple(rest)
    if sx[0]:                    # each chip fetches its rows of the result
        m.emit("all-to-all", m.local(outs[0], spec))
    return [spec]


def _gather(m, func, args, kwargs, ins, outs):
    x, dim, idx = args[0], args[1] % args[0].dim(), args[2]
    sx = m.spec(x)
    si = list(m.spec(idx))
    used = _axes(si)
    for d in range(idx.dim()):
        if (d != dim and not si[d] and sx[d] and idx.shape[d] == x.shape[d]
                and not set(sx[d]) & used):
            si[d] = sx[d]
            used |= set(sx[d])
    spec = tuple(si)
    if sx[dim]:
        m.emit("all-reduce", m.local(outs[0], spec))
    return [spec]


def _scatter(m, func, args, kwargs, ins, outs):
    x, dim, idx = args[0], args[1] % args[0].dim(), args[2]
    src = args[3] if len(args) > 3 and isinstance(args[3],
                                                  torch.Tensor) else None
    si = m.spec(idx)
    if getattr(x, ATTR, None) is FREE:
        spec = tuple(() if d == dim or idx.shape[d] != x.shape[d] else e
                     for d, e in enumerate(si))
    else:
        spec = m.spec(x)
    spread = _axes(si)
    if src is not None and getattr(src, ATTR, None) is not FREE:
        spread |= _axes(m.spec(src))
    if spread - _axes(spec):
        m.emit("all-reduce", m.local(outs[0], spec))
    return [spec]


def _index_put(m, func, args, kwargs, ins, outs):
    x = args[0]
    if getattr(x, ATTR, None) is FREE:
        vals = args[2]
        if vals.shape == x.shape:
            return [m.spec(vals)]
        return [FREE]
    return [m.spec(x)]


def _cat(m, func, args, kwargs, ins, outs):
    ts = [t for t in args[0] if t.dim() == outs[0].dim()]
    dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0))
    dim %= outs[0].dim()
    ruled = [t for t in ts if getattr(t, ATTR, None) is not FREE]
    if not ruled:
        return [FREE]
    prim = max(ruled, key=lambda t: t.numel())
    s = m.spec(prim)
    if len(ruled) == 1 and len(ts) > 1:
        # the other pieces are factory-made (a pad row): they sit on the
        # last shard, the partitioner's uneven split of the dim
        return [s]
    spec = _without(s, set(s[dim]))
    for t in ruled:
        m.move(t, m.spec(t), spec)
    return [spec]


def _stack(m, func, args, kwargs, ins, outs):
    ts = args[0]
    dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0))
    dim %= outs[0].dim()
    ruled = [t for t in ts if getattr(t, ATTR, None) is not FREE]
    if not ruled:
        return [FREE]
    prim = max(ruled, key=lambda t: t.numel() / m.split(m.spec(t)))
    spec = m.spec(prim)
    for t in ruled:
        m.move(t, m.spec(t), spec)
    return [tuple(spec[:dim]) + ((),) + tuple(spec[dim:])]


def _pad(m, func, args, kwargs, ins, outs):
    x, pad = args[0], args[1]
    s = m.spec(x)
    padded = {x.dim() - 1 - i // 2 for i in range(len(pad)) if pad[i]}
    axes = {a for d in padded for a in s[d]}
    if axes:
        s = _without(s, axes)
        m.emit("all-gather", m.local(x, s))
    return [s]


def _select_bwd(m, func, args, kwargs, ins, outs):
    g, dim = args[0], args[2] % outs[0].dim()
    s = list(m.spec(g))
    s.insert(dim, ())
    return [tuple(s)]


def _slice_bwd(m, func, args, kwargs, ins, outs):
    g, dim = args[0], args[2] % args[0].dim()
    s = m.spec(g)
    if s[dim] and outs[0].shape[dim] != g.shape[dim]:
        s = _without(s, set(s[dim]))
        m.emit("all-gather", m.local(g, s))
    return [s]


# ---- the attention kernels' shape-only operators ---------------------------

def _kv_target(m, q_spec, k):
    """k, v [B, KVH, S, D] in q's batch and head layout, sequence whole."""
    heads = q_spec[1] if k.shape[1] % m.split((q_spec[1],)) == 0 else ()
    return (q_spec[0], heads, (), ())


def _flash(m, func, args, kwargs, ins, outs):
    q, k, v = args[0], args[1], args[2]
    sq = m.spec(q)
    sq = sq[:3] + ((),) if sq[3] else sq
    tgt = _kv_target(m, sq, k)
    for t in (k, v):
        m.move(t, m.spec(t), tgt)
    lse = sq[:3] if outs[1].dim() == 3 else ((),) * outs[1].dim()
    return [sq, lse]


def _flash_bwd(m, func, args, kwargs, ins, outs):
    q, k, v = args[0], args[1], args[2]
    sq = m.spec(q)
    sq = sq[:3] + ((),) if sq[3] else sq
    tgt = _kv_target(m, sq, k)
    for t in (k, v):
        m.move(t, m.spec(t), tgt)
    if not _axes(sq) - _axes(tgt):
        return [sq, tgt, tgt]
    # partial sums over q's row shards: all-reduced, then each chip keeps
    # its block of k's and v's own layout (the forward gather's transpose)
    for g in outs[1:]:
        m.emit("all-reduce", m.local(g, tgt))
    return [sq, m.spec(k), m.spec(v)]


def _decode(m, func, args, kwargs, ins, outs):
    q, k = args[0], args[1]
    sk, sq = m.spec(k), m.spec(q)
    seq = set(sk[2])
    tgt = (sk[0], tuple(a for a in sq[1] if a not in seq
                        and a not in sk[0]), ())
    m.move(q, sq, tgt)
    stats = tgt[:2] + ((),)
    if seq:
        m.emit("all-reduce", m.local(outs[0], tgt))
        for o in outs[1:]:
            m.emit("all-reduce", m.local(o, stats))
    return [tgt, stats, stats]


# ---------------------------------------------------------------------------

_R = {}


def _rule(fn, *ops):
    for op in ops:
        _R[op] = fn


# the ops of every dry-run cell (any other takes _fallback, and is
# counted in SpecPass.unruled)
_rule(_same, "detach", "clone", "_to_copy", "flip", "tril")
_rule(_pointwise, "add", "sub", "mul", "div", "where", "pow", "exp", "log",
      "neg", "abs", "sgn", "sqrt", "rsqrt", "reciprocal", "cos", "sin",
      "tanh", "sigmoid", "silu", "gelu", "tanh_backward", "sigmoid_backward",
      "silu_backward", "gelu_backward", "clamp", "clamp_min", "clamp_max",
      "eq", "ne", "lt", "ge", "rsub", "logaddexp", "bitwise_and",
      "floor_divide")
_rule(_copy_, "copy_")
_rule(_like, "empty_like", "zeros_like", "ones_like")
_rule(_factory, "arange", "full", "zeros", "ones", "scalar_tensor",
      "new_zeros")
_rule(_permute, "permute")
_rule(_transpose, "transpose", "t")
_rule(_unsqueeze, "unsqueeze")
_rule(_squeeze, "squeeze")
_rule(_select, "select")
_rule(_unbind, "unbind")
_rule(_slice, "slice")
_rule(_expand, "expand")
_rule(_reshape, "view", "_unsafe_view")
_rule(_mm, "mm")
_rule(_bmm, "bmm")
_rule(_reduce, "sum", "mean", "var", "logsumexp", "argmax")
_rule(_softmax, "_softmax", "_softmax_backward_data")
_rule(_scan, "sort", "topk", "cumsum", "cummax")
_rule(_embedding, "embedding")
_rule(_embedding_bwd, "embedding_dense_backward")
_rule(_index, "index")
_rule(_gather, "gather")
_rule(_scatter, "scatter", "scatter_", "scatter_add", "scatter_add_")
_rule(_index_put, "index_put")
_rule(_cat, "cat")
_rule(_stack, "stack")
_rule(_pad, "constant_pad_nd")
_rule(_select_bwd, "select_backward")
_rule(_slice_bwd, "slice_backward")
_rule(_flash, "flash_attention")
_rule(_flash_bwd, "flash_attention_bwd")
_rule(_decode, "decode_attention")


_KEEP_PENDING = {_same, _permute, _transpose, _unsqueeze, _squeeze,
                 _reshape, _expand, _pointwise}
_ADOPT = {_pointwise, _mm, _bmm, _copy_, _like}   # take PENDING inputs


_LINEAR_1 = {_same, _permute, _transpose, _unsqueeze, _squeeze, _select,
             _unbind, _slice, _expand, _reshape}


def _linear(m, fn, func, args, ins) -> Optional[Partial]:
    """The partial-sum marker an op may carry from its inputs to its
    outputs: a partial sum stays pending through an op linear in it (a
    view, a cast, a sum, an add of partial sums, a product with whole
    operands that do not split its axes, a contraction with one whole
    operand), and is all-reduced where it is first needed whole, so a
    loop's per-step gradient contributions (the sLSTM's recurrent
    weight) accumulate before their one reduction, as a scan's carry
    does.  None where the op needs its partial inputs whole (or has
    none)."""
    marks = {p for p in (m.partial(t) for t in ins) if p is not None}
    if len(marks) != 1:
        return None
    keep = marks.pop()
    axes = {a for g in keep for a in g}
    whole = [t for t in ins if m.partial(t) is None
             and getattr(t, ATTR, None) not in (FREE, PENDING)]
    if any(_axes(m.spec(t)) & axes for t in whole):
        return None
    name = func.overloadpacket.__name__
    n_part = len(ins) - len(whole) - sum(
        getattr(t, ATTR, None) in (FREE, PENDING) for t in ins)  # x * x: 2
    if fn in _LINEAR_1 or fn is _select_bwd or fn is _slice_bwd:
        return keep
    if fn in (_mm, _bmm):
        return keep if n_part == 1 else None
    if fn is _reduce:
        return keep if name in ("sum", "mean") else None
    if fn is _pointwise:
        ok = (name in ("add", "sub") and not whole
              or name in ("mul", "neg") and n_part == 1
              or name == "div" and n_part == 1
              and m.partial(args[0]) is not None)
        return keep if ok else None
    if fn in (_cat, _stack):
        return keep if not whole else None
    return None


def _carried(m, keep, ins, outs, specs) -> Optional[Partial]:
    """``keep`` where the op's outputs hold no more bytes a chip than its
    largest partial input (else reducing first moves less); the partial
    inputs all-reduced where nothing is carried."""
    parts = list({id(t): t for t in ins
                  if m.partial(t) is not None}.values())
    if not parts:
        return None
    if keep is not None:
        size = max(m.local(t, m.spec(t)) for t in parts)
        out = sum(m.local(o, _strip(s) if type(s) is tuple
                          else ((),) * o.dim()) for o, s in zip(outs, specs))
        if out > size:
            keep = None
    if keep is None:
        for t in parts:
            m.reduce(t)
    return keep


def _strip(spec) -> Tuple:
    return spec[:-1] if spec and type(spec[-1]) is Partial else spec


def _mark(spec, keep: Partial):
    """``spec`` with the carried marker ``keep`` merged into its own."""
    if spec is FREE or spec is PENDING:
        return spec
    if spec and type(spec[-1]) is Partial:
        groups = tuple(sorted(set(spec[-1]) | set(keep)))
        return tuple(spec[:-1]) + (Partial(groups),)
    return tuple(spec) + (keep,)


def _fallback(m, func, args, kwargs, ins, outs):
    """No rule: every sharded input gathered, the outputs replicated."""
    for t in ins:
        s = m.spec(t)
        if _axes(s):
            m.emit("all-gather", t.numel() * t.element_size())
    return [((),) * o.dim() for o in outs]


def _retag(t: torch.Tensor, tag) -> None:
    if tag is None:
        if getattr(t, ATTR, None) is not None:
            delattr(t, ATTR)
    else:
        setattr(t, ATTR, tag)


class SpecPass:
    """Specs for each of ``meshes`` (name -> mesh) on every tensor of a
    traced step, and the collectives they imply (module docstring):
    ``bytes[name]`` and ``counts[name]`` per collective type."""

    def __init__(self, meshes: Dict[str, object]):
        self.names = tuple(meshes)
        self.meshes = tuple(meshes.values())
        self.sizes = tuple(dict(mesh.shape) for mesh in self.meshes)
        self.units = []
        for mesh in self.meshes:
            batch = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
            self.units.append([u for u in (batch, ("model",))
                               if u and set(u) <= set(mesh.axis_names)])
        self.bytes: Dict[str, Dict[str, float]] = {n: {} for n in self.names}
        self.counts: Dict[str, Dict[str, int]] = {n: {} for n in self.names}
        self.unruled: Dict[str, int] = {}
        self._ctxs = None
        self._fns: Dict = {}

    # ---- tags from outside the ops ----------------------------------------
    def tag(self, tree, specs: Sequence) -> None:
        """Tag the tensors of ``tree`` with ``specs`` (one congruent tree
        of ``sharding`` specs per mesh, in order)."""
        from repro_torch.launch.dryrun import _paired

        pairs = [list(_paired(tree, s)) for s in specs]
        for i, (t, _) in enumerate(pairs[0]):
            setattr(t, ATTR, tuple(norm(p[i][1], t.dim()) for p in pairs))

    def listen(self, ctx, *, sequence_parallel: bool,
               long_context: bool) -> None:
        """Learn every ``shard_act`` spec of ``ctx`` (a ``ShardCtx``) on
        each of this pass's meshes."""
        from repro_torch.distributed.ctx import ShardCtx

        self._ctxs = [ShardCtx(mesh, sequence_parallel=sequence_parallel,
                               long_context=long_context)
                      for mesh in self.meshes]
        ctx.listener = self.constrain

    def constrain(self, x: torch.Tensor, kind: str) -> None:
        """``shard_act(x, kind)``: move ``x`` to the kind's spec on each
        mesh, and its gradient likewise in the backward."""
        self._constrain(x, kind)
        if x.requires_grad:
            x.register_hook(lambda g: self._constrain(g, kind))

    def _constrain(self, x: torch.Tensor, kind: str) -> None:
        from repro_torch.distributed.ctx import _guard

        tag = getattr(x, ATTR, None)
        new = []
        for i, ctx in enumerate(self._ctxs):
            spec = ctx.spec(kind, x.dim())
            m = _Mesh(i, self.sizes[i], self.units[i])
            if spec is None:
                new.append(tag[i] if type(tag) is tuple else m.spec(x))
                continue
            tgt = norm(_guard(spec, tuple(x.shape), ctx.mesh), x.dim())
            if m.partial(x) is not None:
                m.reduce(x)
            if tag is PENDING:
                m.resolve(x, tgt)
            elif tag is not FREE:
                m.move(x, m.spec(x), tgt)
            self._add(i, m.ev)
            new.append(tgt)
        setattr(x, ATTR, None if not any(_axes(s) for s in new)
                else tuple(new))

    # ---- the ops -----------------------------------------------------------
    def rule(self, func, args, kwargs, ins: List[torch.Tensor],
             outs: List[torch.Tensor]):
        """The effect of one op: (its outputs' tags, its events (mesh
        index, type, bytes), the new tags of inputs it reduced or laid
        out (input position, tag)), or None where nothing is tagged."""
        if not outs:
            return None
        fn = self._fns.get(func)
        if fn is None:
            fn = self._fns[func] = _R.get(func.overloadpacket.__name__,
                                          _fallback)
        if fn is not _factory:
            tags = [getattr(t, ATTR, None) for t in ins]
            if not ins:
                return [FREE] * len(outs), [], []
            if all(t is None for t in tags):
                return None
            if all(t is FREE for t in tags):
                return [FREE] * len(outs), [], []
            if (PENDING in tags and fn in _KEEP_PENDING
                    and all(t in (None, FREE, PENDING) for t in tags)):
                return [PENDING] * len(outs), [], []
        if fn is _fallback:
            name = func.overloadpacket.__name__
            self.unruled[name] = self.unruled.get(name, 0) + 1
        per, events, ms = [], [], []
        for i, sizes in enumerate(self.sizes):
            m = _Mesh(i, sizes, self.units[i])
            ms.append(m)
            if fn not in _ADOPT:
                for t in ins:
                    if m.pending(t):
                        m.resolve(t, m.default(t))
            keep = _linear(m, fn, func, args, ins)
            specs = fn(m, func, args, kwargs, ins, outs)
            if fn is not _like:           # reads no values: nothing to sum
                keep = _carried(m, keep, ins, outs, specs)
            if keep is not None:
                specs = [_mark(s, keep) for s in specs]
            per.append(specs)
            events.extend((i, k, b) for k, b in m.ev)
        out_tags = []
        for j in range(len(outs)):
            specs = [p[j] for p in per]
            if all(s is FREE for s in specs):
                out_tags.append(FREE)
            elif all(s is PENDING for s in specs):
                out_tags.append(PENDING)
            else:
                specs = [((),) * outs[j].dim() if s in (FREE, PENDING)
                         else s for s in specs]
                out_tags.append(tuple(specs) if any(_axes(s) for s in specs)
                                else None)
        # an input reduced or laid out here stays so for its later readers
        in_tags = []
        for j, t in enumerate(ins):
            if any(id(t) in m.fixed for m in ms):
                new = tuple(m.fixed.get(id(t), m.spec(t)) for m in ms)
                in_tags.append((j, new if any(_axes(s) for s in new)
                                else None))
        return out_tags, events, in_tags

    def finish(self, tree) -> None:
        """All-reduce the partial sums among a step's outputs (a result
        leaves the step whole)."""
        from repro_torch.launch.dryrun import _tensors

        for t in _tensors(tree, []):
            if type(getattr(t, ATTR, None)) is not tuple:
                continue
            whole = []
            for i, sizes in enumerate(self.sizes):
                m = _Mesh(i, sizes, self.units[i])
                if m.partial(t) is not None:
                    m.reduce(t)
                    self._add(i, m.ev)
                whole.append(m.spec(t))
            setattr(t, ATTR, tuple(whole))

    def apply(self, outs: List[torch.Tensor], effect, inputs=None) -> None:
        """Tag an op's outputs (and the inputs it reduced, found in
        ``inputs``: its args and kwargs) and count its events."""
        if effect is None:
            return
        out_tags, events, in_tags = effect
        if in_tags:
            from repro_torch.launch.dryrun import _tensors

            ins = _tensors(inputs, [])
            for j, tag in in_tags:
                _retag(ins[j], tag)
        for t, tag in zip(outs, out_tags):
            _retag(t, tag)
        for i, kind, nbytes in events:
            b, c = self.bytes[self.names[i]], self.counts[self.names[i]]
            b[kind] = b.get(kind, 0.0) + nbytes
            c[kind] = c.get(kind, 0) + 1

    def _add(self, i: int, events) -> None:
        b, c = self.bytes[self.names[i]], self.counts[self.names[i]]
        for kind, nbytes in events:
            b[kind] = b.get(kind, 0.0) + nbytes
            c[kind] = c.get(kind, 0) + 1
