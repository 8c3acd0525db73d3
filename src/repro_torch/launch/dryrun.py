"""Dry run: every (arch x shape x mesh) cell traced on ``meta``.

A port of the JAX package's ``repro.launch.dryrun``.  Proves that each
model configuration the port runs steps at its full published width, for
every input shape of ``config.SHAPES`` and both production meshes,
without a card and without allocating: parameters (``param_shapes``),
optimizer state and inputs (``input_specs``) are ``meta`` tensors, and
the port's real step (``train.steps``) runs on them eagerly, under
``use_mesh``.  Where the JAX dry run lowers and compiles for 512
placeholder devices, this one executes the step's Python on meta tensors:
loops run their real trip counts and Python ``if``s take their real
branch, so nothing needs correcting afterwards.

One :class:`StepCounter` (a ``TorchDispatchMode``) watches every aten op
of the step:

  flops   ``torch.utils.flop_counter``'s formulas (matmuls, and the
          attention kernels' shape-only operators, ``kernels._meta``);
  bytes   each op's input and output bytes: the port runs eagerly, so
          every op reads its inputs from and writes its outputs to HBM.
          View and alias ops, and ``empty*``, count none; a gather
          (``embedding``, ``index``, ``index_select``, ``gather``) counts
          the rows it reads, not its whole table;
  peak    live bytes of the storages the step makes (the arguments'
          excluded), the high-water mark.

Each (arch, shape) is traced once, under the single-pod mesh; both
meshes' records come from that trace: the mesh changes only the specs
(``distributed.sharding``, ``distributed.ctx``) and the divisor.  The
port has no SPMD partitioner, so a record's per-chip FLOPs and bytes
split the global ones evenly over the chips.  Its collectives come from
the spec pass of ``distributed.spmd``, which rides the same trace with a
spec for each mesh at once: ``collective_bytes`` (per-chip result bytes
times the wire factor, by type) and ``collective_counts`` count every
executed collective, loops and the remat recomputation included.

Meta ops are slow in PyTorch (many have Python meta kernels); a step
repeats the same op on the same shapes many times (the sLSTM's time
loop above all), so the counter memoizes each functional op's output
shapes, strides, bytes and FLOPs by its arguments' metadata and, on a
repeat, makes the outputs with ``empty_strided`` on ``meta``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # every cell (cached)
  python -m repro_torch.launch.dryrun --all --force --jobs 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import weakref
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.spmd import ATTR as SPEC_TAG

RESULTS_DIR = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
MESHES = ("single", "multi")
HBM_CAPACITY = 80e9   # bytes: the "80GB" of one NVIDIA H100 80GB HBM3
NOTE = ("per-chip flops and bytes split the global step evenly over n_chips "
        "(the port has no SPMD partitioner); collective_bytes (per-chip "
        "result bytes x wire factor) and collective_counts are the spec "
        "pass's (distributed.spmd) executed collectives on this mesh, by "
        "type, from the one meta trace of the (arch, shape)")

_aten = torch.ops.aten
_EMPTY = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default, _aten.new_empty.default,
          _aten.new_empty_strided.default}
# a gather reads the rows it returns, not its whole table (its first
# argument)
_SPARSE_READS = {_aten.embedding.default, _aten.index.Tensor,
                 _aten.index_select.default, _aten.gather.default}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sig(x, tags: bool = False):
    """Hashable metadata of an op argument (with ``tags``, a tensor's spec
    tag too); raises TypeError for one the memo does not know (the op then
    runs unmemoized)."""
    if isinstance(x, torch.Tensor):
        if tags:
            return (x.shape, x.stride(), x.dtype, x.is_meta,
                    getattr(x, SPEC_TAG, None))
        return (x.shape, x.stride(), x.dtype, x.is_meta)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y, tags) for y in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _sig(v, tags)) for k, v in x.items())) \
            if x else ()
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return (type(x).__name__, x)
    if isinstance(x, torch.Generator):   # shapes do not depend on it
        return ("Generator",)
    raise TypeError(type(x))


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or outputs (lists and tuples
    nested), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


class StepCounter(TorchDispatchMode):
    """FLOPs, bytes read and written, and peak live bytes of a step's aten
    ops (module docstring).  ``keep`` holds tensors that exist before the
    step (its arguments): their storages are never counted as live.
    ``spmd`` (a ``distributed.spmd.SpecPass``) is given every op to tag
    its outputs' specs; its effect joins a memoized op's record, keyed by
    the inputs' specs too (a view's effect has a memo of its own)."""

    VIEW, MUTABLE, FUNCTIONAL = range(3)

    def __init__(self, keep=(), spmd=None):
        super().__init__()
        self.spmd = spmd
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        # storage -> a weak reference whose callback frees its bytes
        # (None for the arguments' storages, which are never counted)
        self._known = {t.untyped_storage()._cdata: None for t in keep}
        self._kinds: Dict = {}
        self._memo: Dict = {}
        self._view_memo: Dict = {}

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._known[key] = weakref.ref(st, partial(self._forget, key, n))

    def _forget(self, key, n: int, _ref) -> None:
        del self._known[key]
        self.live -= n

    def _kind(self, func) -> int:
        k = self._kinds.get(func)
        if k is None:
            s = func._schema
            k = self._kinds[func] = (
                self.MUTABLE if s.is_mutable
                else self.VIEW if any(r.alias_info is not None
                                      for r in s.returns)
                else self.FUNCTIONAL)
        return k

    def _cost(self, func, args, kwargs, ins, outs, out) -> Tuple[int, int]:
        """(bytes, flops) of one op that is not a view."""
        if func in _EMPTY:
            moved = 0
        else:
            moved = sum(map(nbytes, ins)) + sum(map(nbytes, outs))
            if func in _SPARSE_READS:
                moved += sum(map(nbytes, outs)) - nbytes(args[0])
        fn = flop_registry.get(func.overloadpacket)
        flops = int(fn(*args, **kwargs, out_val=out)) if fn else 0
        return moved, flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        kind = self._kind(func)
        spmd = self.spmd
        tags = spmd is not None
        if kind == self.VIEW:              # moves nothing, makes nothing
            out = func(*args, **kwargs)
            if tags:
                self._view_specs(func, args, kwargs, out)
            return out
        key = None
        if kind == self.FUNCTIONAL:
            try:
                key = (func, _sig(args, tags), _sig(kwargs, tags))
            except TypeError:
                key = None
            hit = self._memo.get(key) if key is not None else None
            if hit is not None:
                spec, single, moved, flops, effect = hit
                outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                        for sh, st, dt in spec]
                self.bytes += moved
                self.flops += flops
                self._track(outs)
                if effect is not None:
                    spmd.apply(outs, effect, (args, kwargs))
                return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs), [])
        outs = _tensors(out, [])
        in_st = {a.untyped_storage()._cdata for a in ins}
        aliased = any(o.untyped_storage()._cdata in in_st for o in outs)
        if aliased and kind == self.FUNCTIONAL:
            moved, flops = 0, 0            # a view its schema does not say
        else:
            moved, flops = self._cost(func, args, kwargs, ins, outs, out)
        self.bytes += moved
        self.flops += flops
        effect = None
        if tags:
            effect = spmd.rule(func, args, kwargs, ins, outs)
            if effect is not None:
                spmd.apply(outs, effect, (args, kwargs))
        if (key is not None and not aliased and outs
                and (isinstance(out, torch.Tensor)
                     or (type(out) is tuple and len(out) == len(outs)))
                and all(o.is_meta and o.storage_offset() == 0
                        for o in outs)):
            spec = [(tuple(o.shape), o.stride(), o.dtype) for o in outs]
            self._memo[key] = (spec, isinstance(out, torch.Tensor), moved,
                               flops, effect)
        self._track(outs)
        return out

    def _view_specs(self, func, args, kwargs, out) -> None:
        x, rest = args[0], args[1:]
        key = None
        if isinstance(x, torch.Tensor) and not kwargs and not any(
                isinstance(a, torch.Tensor) for a in rest):
            # a view's specs depend on its input's shape, dtype and tag
            # and on its other (int) arguments only
            tag = getattr(x, SPEC_TAG, None)
            if tag is None:
                return                     # a replicated view: no tag
            key = (func, x.shape, x.dtype, tag,
                   *[tuple(a) if type(a) is list else a for a in rest])
        else:
            try:
                key = (func, _sig(args, True), _sig(kwargs, True))
            except TypeError:
                pass
        effect = self._view_memo.get(key, False) if key else False
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out, [])
        if effect is False:
            effect = self.spmd.rule(func, args, kwargs,
                                    _tensors((args, kwargs), []), outs)
            if key is not None:
                self._view_memo[key] = effect
        if effect is not None:
            self.spmd.apply(outs, effect, (args, kwargs))


def _leaves(tree) -> List[torch.Tensor]:
    return [t for t, _ in _paired(tree, tree)]


def trace_step(cfg, shape, mesh, *, long_context: bool,
               meshes: Optional[Dict] = None) -> Dict:
    """The port's real step of ``shape.kind`` on meta tensors, under
    ``use_mesh(mesh)`` and a :class:`StepCounter`: its arguments and
    outputs (meta trees), the counts, the activation records and the
    trace's seconds.  With ``meshes`` (name -> mesh) a spec pass rides
    the trace (``spmd``: its collectives on each of them)."""
    from repro_torch.distributed.ctx import use_mesh
    from repro_torch.distributed.spmd import SpecPass
    from repro_torch.models.registry import input_specs, param_shapes
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    t0 = time.perf_counter()
    params = param_shapes(cfg)
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        state = steps.TrainState(
            params=params, opt=adamw.init(params),
            step=torch.zeros((), dtype=torch.int32, device="meta"))
        args = (state, batch)
        fn = steps.make_train_step(cfg, adamw.AdamWConfig())
    elif shape.kind == "prefill":
        args = (params, batch)
        fn = steps.make_prefill_step(cfg)
    else:
        args = (params, batch)
        fn = steps.make_serve_step(cfg)
    spmd = None
    if meshes:
        spmd = SpecPass(meshes)
        spmd.tag(args, [arg_specs(cfg, shape, args, m)
                        for m in meshes.values()])
    counter = StepCounter(keep=_leaves(args), spmd=spmd)
    sp = cfg.sequence_parallel and not long_context
    with use_mesh(mesh, sequence_parallel=sp,
                  long_context=long_context) as ctx:
        if spmd is not None:
            spmd.listen(ctx, sequence_parallel=sp, long_context=long_context)
        with counter:
            out = fn(*args)
    if spmd is not None:
        spmd.finish(out)
    return dict(args=args, out=out, flops=counter.flops,
                bytes=counter.bytes, peak=counter.peak, ops=counter.ops,
                records=ctx.records, spmd=spmd,
                lower_s=time.perf_counter() - t0)


def _paired(tree, specs):
    """(tensor, spec) at every tensor leaf of ``tree``, ``specs`` a
    congruent tree (a spec is itself a tuple: the tensors' tree leads)."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paired(v, specs[k])
    elif isinstance(tree, (tuple, list)):
        for v, s in zip(tree, specs, strict=True):
            yield from _paired(v, s)


def _spec_bytes(tree, specs, mesh) -> int:
    """Per-chip bytes of a tree of tensors under a congruent tree of
    specs."""
    from repro_torch.distributed.sharding import local_shape

    total = 0
    for t, s in _paired(tree, specs):
        n = 1
        for d in local_shape(t.shape, s, mesh):
            n *= d
        total += n * t.element_size()
    return total


def _policy(cfg):
    from repro_torch.distributed import sharding as shd

    return shd.ShardingPolicy(fsdp=True,
                              sequence_parallel=cfg.sequence_parallel)


def arg_specs(cfg, shape, args, mesh) -> Tuple:
    """Specs of a step's arguments on ``mesh``: the parameters and
    optimizer moments by ``param_shardings``, the inputs by
    ``batch_specs``, a scalar replicated."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    first, batch = args
    bspec = shd.batch_specs(batch, mesh,
                            long_context=shape.name == "long_500k")
    if shape.kind == "train":
        pspec = shd.param_shardings(first.params, mesh, _policy(cfg))
        return (steps.TrainState(params=pspec,
                                 opt=adamw.OptState(m=pspec, v=pspec,
                                                    step=()),
                                 step=()), bspec)
    return shd.param_shardings(first, mesh, _policy(cfg)), bspec


def arg_out_specs(cfg, shape, trace, mesh) -> Tuple:
    """(argument specs, output specs) of a traced step on ``mesh``
    (:func:`arg_specs`); the new state keeps its input's specs, every
    other output is laid out by ``batch_specs`` (batch-major; a cache as
    a cache), a scalar replicated."""
    from repro_torch.distributed import sharding as shd

    long_ctx = shape.name == "long_500k"
    aspec = arg_specs(cfg, shape, trace["args"], mesh)
    if shape.kind == "train":
        new_state, metrics = trace["out"]
        return aspec, (aspec[0], shd.batch_specs(metrics, mesh))
    out = trace["out"]
    ospec = shd.batch_specs(out if isinstance(out, dict)
                            else {"logits": out}, mesh,
                            long_context=long_ctx)
    if not isinstance(out, dict):
        ospec = ospec["logits"]
    return aspec, ospec


def activations(records, mesh, *, sequence_parallel: bool,
                long_context: bool) -> Dict:
    """Per ``shard_act`` kind: its calls, and the spec and per-chip shape
    of its largest tensor on ``mesh`` (the records re-read under that
    mesh's context)."""
    from repro_torch.distributed.ctx import ShardCtx, _guard
    from repro_torch.distributed.sharding import local_shape

    ctx = ShardCtx(mesh, sequence_parallel=sequence_parallel,
                   long_context=long_context)
    out: Dict = {}
    for kind, shape, _, _ in records:
        spec = _guard(ctx.spec(kind, len(shape)), shape, mesh)
        loc = local_shape(shape, spec, mesh)
        n = 1
        for d in loc:
            n *= d
        a = out.setdefault(kind, {"calls": 0, "numel": -1})
        a["calls"] += 1
        if n > a["numel"]:
            a.update(numel=n, spec=list(spec), local_shape=list(loc),
                     shape=list(shape))
    return out


def _record(cfg, shape, trace, arch_id: str, mesh_kind: str,
            model_flops: float) -> Dict:
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    long_ctx = shape.name == "long_500k"
    n_chips = 1
    for v in mesh.shape.values():
        n_chips *= v
    aspec, ospec = arg_out_specs(cfg, shape, trace, mesh)
    spmd = trace.get("spmd")
    coll = spmd is not None and mesh_kind in spmd.bytes
    arg_b = _spec_bytes(trace["args"], aspec, mesh)
    out_b = _spec_bytes(trace["out"], ospec, mesh)
    temp_b = trace["peak"] // n_chips
    return {
        "status": "OK",
        "arch": arch_id,
        "shape": shape.name,
        "mesh": mesh_kind,
        "mesh_shape": dict(mesh.shape),
        "n_chips": n_chips,
        "device": "meta",
        "lower_s": round(trace["lower_s"], 3),
        "aten_ops": trace["ops"],
        "memory_analysis": {
            "argument_size_in_bytes": arg_b,
            "output_size_in_bytes": out_b,
            "temp_size_in_bytes": temp_b,
        },
        "cost_analysis": {
            "flops": trace["flops"] / n_chips,
            "bytes accessed": trace["bytes"] / n_chips,
        },
        "global": {"flops": trace["flops"], "bytes accessed": trace["bytes"],
                   "peak_live_bytes": trace["peak"]},
        "model_flops": model_flops,
        "fits": arg_b + temp_b <= HBM_CAPACITY,
        "hbm_capacity_bytes": HBM_CAPACITY,
        "collective_bytes": dict(spmd.bytes[mesh_kind]) if coll else {},
        "collective_counts": dict(spmd.counts[mesh_kind]) if coll else {},
        "collective_unruled": dict(spmd.unruled) if coll else {},
        "activations": activations(
            trace["records"], mesh,
            sequence_parallel=cfg.sequence_parallel and not long_ctx,
            long_context=long_ctx),
        "note": NOTE,
    }


def cell_records(cfg, shape, arch_id: str,
                 meshes=MESHES) -> Dict[str, Dict]:
    """Records of ``cfg`` at ``shape`` on each of ``meshes`` (production
    meshes by name) from one meta trace."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import model_flops

    trace = trace_step(cfg, shape, make_production_mesh(),
                       long_context=shape.name == "long_500k",
                       meshes={m: make_production_mesh(
                           multi_pod=(m == "multi")) for m in meshes})
    mf = model_flops(cfg, shape)
    return {m: _record(cfg, shape, trace, arch_id, m, mf) for m in meshes}


def run_cells(arch_id: str, shape_id: str,
              meshes=MESHES) -> Dict[str, Dict]:
    """Records of one (arch, shape) on each of ``meshes`` from one meta
    trace (``SKIP`` records, with ``shape_applicable``'s reason, where the
    shape does not apply)."""
    from repro_torch.config import SHAPES, get_arch, shape_applicable

    cfg = get_arch(arch_id)
    shape = SHAPES[shape_id]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {m: {"status": "SKIP", "arch": arch_id, "shape": shape_id,
                    "mesh": m, "reason": reason} for m in meshes}
    return cell_records(cfg, shape, arch_id, meshes)


def run_cell(arch_id: str, shape_id: str, mesh_kind: str) -> Dict:
    """One cell's record (the JAX dry run's entry point)."""
    return run_cells(arch_id, shape_id, (mesh_kind,))[mesh_kind]


def _worker(arch_id: str, shape_id: str) -> Tuple[Dict, bool]:
    """A sweep worker's cell pair, and whether its process touched CUDA."""
    recs = run_cells(arch_id, shape_id)
    return recs, torch.cuda.is_initialized()


def sweep(jobs: int = 1, cells: Optional[List[Tuple[str, str]]] = None
          ) -> Tuple[List[Dict], bool]:
    """Every (arch, shape) of ``cells`` (default: all of ``ARCH_IDS`` x
    ``SHAPES``) on both meshes: (records, whether any worker process
    initialised CUDA).  ``jobs`` > 1 traces the pairs in that many
    ``spawn`` processes, the xLSTM's (the longest: the sLSTM's time loop)
    first."""
    from repro_torch.config import ARCH_IDS, SHAPES

    cells = cells or [(a, s) for a in ARCH_IDS for s in SHAPES]
    if jobs <= 1:
        pairs = [(run_cells(a, s), torch.cuda.is_initialized())
                 for a, s in cells]
    else:
        import concurrent.futures as cf
        import multiprocessing

        order = sorted(cells, key=lambda c: not c[0].startswith("xlstm"))
        with cf.ProcessPoolExecutor(
                max_workers=jobs,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = {c: ex.submit(_worker, *c) for c in order}
            pairs = [futs[c].result() for c in cells]
    records = [r[m] for r, _ in pairs for m in MESHES]
    return records, any(touched for _, touched in pairs)


def cell_path(arch_id, shape_id, mesh_kind) -> Path:
    return RESULTS_DIR / f"{arch_id}__{shape_id}__{mesh_kind}.json"


def main() -> int:
    from repro_torch.config import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: trace in this many processes")
    args = ap.parse_args()

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    if not args.all:
        out = run_cell(args.arch, args.shape, args.mesh)
        cell_path(args.arch, args.shape, args.mesh).write_text(
            json.dumps(out, indent=2))
        print(json.dumps(out, indent=2))
        return 0 if out["status"] in ("OK", "SKIP") else 1

    todo = [(a, s) for a in ARCH_IDS for s in SHAPES
            if args.force or not all(cell_path(a, s, m).exists()
                                     for m in MESHES)]
    print(f"{len(todo)} (arch, shape) pairs to trace, "
          f"{len(ARCH_IDS) * len(SHAPES) - len(todo)} cached", flush=True)
    t0 = time.perf_counter()
    records, _ = sweep(args.jobs, todo) if todo else ([], False)
    for r in records:
        cell_path(r["arch"], r["shape"], r["mesh"]).write_text(
            json.dumps(r, indent=2))
        print(f"{r['arch']} {r['shape']} {r['mesh']}: {r['status']}"
              + (f" ({r['lower_s']} s)" if r["status"] == "OK" else ""))
    print(f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
