"""The dry run's collectives, the port's against the JAX package's.

For each (arch, shape, mesh) cell: the JAX package's loop-aware count of
its partitioned HLO (``repro.launch.roofline.parse_hlo``, each cell
lowered and compiled as ``repro.launch.dryrun.run_cell`` does, in a
subprocess with 512 placeholder CPU devices) beside the port's
(``repro_torch.launch.dryrun.run_cell``: the spec pass of
``repro_torch.distributed.spmd``), per-chip bytes by collective type and
their ratio (reduce-scatter counted with all-reduce).  ``--by-op`` adds
the port's bytes by aten op and type (the largest first).

Usage:
  PYTHONPATH=src python scripts/collectives_vs_jax.py            # the four gate cells
  PYTHONPATH=src python scripts/collectives_vs_jax.py --cell olmoe_1b_7b train_4k single --by-op 12
  # the JAX side alone (what tests/test_torch_collectives.py runs):
  PYTHONPATH=src python scripts/collectives_vs_jax.py --jax-cell llama3_2_1b train_4k single
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GATE_CELLS = [("llama3_2_1b", "train_4k", "single"),
              ("llama3_2_1b", "train_4k", "multi"),
              ("llama3_2_1b", "decode_32k", "single"),
              ("olmoe_1b_7b", "train_4k", "single")]
# --xla_backend_optimization_level=0 cuts the CPU backend's code
# generation; the partitioned HLO's collectives are the default level's
XLA_FLAGS = ("--xla_force_host_platform_device_count=512 "
             "--xla_backend_optimization_level=0")
KINDS = ("all-gather", "all-reduce", "all-to-all", "collective-permute")


def jax_cell(arch: str, shape_id: str, mesh_kind: str) -> dict:
    """The JAX package's loop-aware collective bytes of one cell (run in a
    process whose ``XLA_FLAGS`` give 512 CPU devices)."""
    import jax
    import jax.numpy as jnp

    from repro.config import SHAPES, get_arch
    from repro.distributed import sharding as shd
    from repro.distributed.ctx import use_mesh
    from repro.launch.mesh import make_production_mesh
    from repro.launch.roofline import parse_hlo
    from repro.models.registry import input_specs, param_shapes
    from repro.optim import adamw
    from repro.train import steps

    cfg, shape = get_arch(arch), SHAPES[shape_id]
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    policy = shd.ShardingPolicy(fsdp=True,
                                sequence_parallel=cfg.sequence_parallel)
    long_ctx = shape.name == "long_500k"
    pshapes = param_shapes(cfg)
    pshard = shd.param_shardings(pshapes, mesh, policy)
    batch = input_specs(cfg, shape)
    bshard = shd.named(shd.batch_specs(batch, mesh, long_context=long_ctx),
                       mesh)

    def placed(tree, shards):
        return jax.tree.map(lambda x, sh: jax.ShapeDtypeStruct(
            x.shape, x.dtype, sharding=sh), tree, shards)

    with use_mesh(mesh, sequence_parallel=cfg.sequence_parallel
                  and not long_ctx, long_context=long_ctx):
        if shape.kind == "train":
            state = jax.eval_shape(lambda p: steps.TrainState(
                params=p, opt=adamw.init(p),
                step=jnp.zeros((), jnp.int32)), pshapes)
            scalar = jax.NamedSharding(mesh, shd.P())
            sshard = steps.TrainState(
                params=pshard, opt=adamw.OptState(m=pshard, v=pshard,
                                                  step=scalar), step=scalar)
            jitted = jax.jit(steps.make_train_step(cfg,
                                                   adamw.AdamWConfig()),
                             donate_argnums=(0,))
            args = (placed(state, sshard), placed(batch, bshard))
        elif shape.kind == "prefill":
            jitted = jax.jit(steps.make_prefill_step(cfg))
            args = (placed(pshapes, pshard), placed(batch, bshard))
        else:
            jitted = jax.jit(steps.make_serve_step(cfg), donate_argnums=(1,))
            args = (placed(pshapes, pshard), placed(batch, bshard))
        text = jitted.lower(*args).compile().as_text()
    weight = 1.0 / cfg.hybrid_attn_every if cfg.hybrid_attn_every else 1.0
    return parse_hlo(text, branch_weight=weight)["coll_bytes"]


def start_jax(arch: str, shape_id: str, mesh_kind: str) -> subprocess.Popen:
    """:func:`jax_cell` in a subprocess (its JSON on the last line)."""
    path = [str(ROOT / "src")] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=XLA_FLAGS,
               PYTHONPATH=os.pathsep.join(path))
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--jax-cell",
         arch, shape_id, mesh_kind], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_jax(proc: subprocess.Popen, timeout: float = 600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX cell failed:\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def by_kind(coll: dict) -> dict:
    """Bytes by the types the comparison reads: the total, all-gather,
    all-reduce (with reduce-scatter), all-to-all, collective-permute."""
    return {"total": sum(coll.values()),
            "all-gather": coll.get("all-gather", 0.0),
            "all-reduce": coll.get("all-reduce", 0.0)
            + coll.get("reduce-scatter", 0.0),
            "all-to-all": coll.get("all-to-all", 0.0),
            "collective-permute": coll.get("collective-permute", 0.0)}


def port_cell(arch: str, shape_id: str, mesh_kind: str, by_op: bool):
    """The port's record of one cell and, with ``by_op``, its bytes by
    (aten op, collective type)."""
    from repro_torch.distributed import spmd
    from repro_torch.launch import dryrun

    ops: dict = {}
    saved = spmd.SpecPass.rule, spmd.SpecPass.apply, spmd.SpecPass._constrain
    rule, apply, constrain = saved

    def named(self, func, args, kwargs, ins, outs):
        effect = rule(self, func, args, kwargs, ins, outs)
        if effect:              # the memo replays the named events
            name = func.overloadpacket.__name__
            effect = (effect[0], [(i, (name, kind), b)
                                  for i, kind, b in effect[1]], effect[2])
        return effect

    def summed(self, outs, effect, inputs=None):
        if effect:
            for i, (name, kind), b in effect[1]:
                if self.names[i] == mesh_kind:
                    ops[(name, kind)] = ops.get((name, kind), 0.0) + b
            effect = (effect[0], [(i, kind, b)
                                  for i, (_, kind), b in effect[1]],
                      effect[2])
        apply(self, outs, effect, inputs)

    def constrained(self, x, kind):
        before = dict(self.bytes[mesh_kind])
        constrain(self, x, kind)
        for k, b in self.bytes[mesh_kind].items():
            if b != before.get(k, 0.0):
                key = (f"shard_act:{kind}", k)
                ops[key] = ops.get(key, 0.0) + b - before.get(k, 0.0)

    if by_op:
        spmd.SpecPass.rule, spmd.SpecPass.apply = named, summed
        spmd.SpecPass._constrain = constrained
    try:
        rec = dryrun.run_cell(arch, shape_id, mesh_kind)
    finally:
        spmd.SpecPass.rule, spmd.SpecPass.apply, spmd.SpecPass._constrain = \
            saved
    return rec, ops


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax-cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--cell", nargs=3, action="append",
                    metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--by-op", type=int, default=0,
                    help="print the port's N largest (op, type) sums")
    args = ap.parse_args()
    if args.jax_cell:
        print(json.dumps(jax_cell(*args.jax_cell)))
        return 0
    cells = [tuple(c) for c in args.cell] if args.cell else GATE_CELLS
    procs = {c: start_jax(*c) for c in cells}
    for c in cells:
        jx = by_kind(finish_jax(procs[c]))
        rec, ops = port_cell(*c, by_op=args.by_op > 0)
        pt = by_kind(rec["collective_bytes"])
        print(" ".join(c), f"(unruled ops: {rec['collective_unruled']})")
        print(f"  {'type':20s} {'port B/chip':>12s} {'JAX B/chip':>12s} "
              f"{'port/JAX':>9s}")
        for k in ("total",) + KINDS:
            ratio = pt[k] / jx[k] if jx[k] else float("nan")
            print(f"  {k:20s} {pt[k]:12.4e} {jx[k]:12.4e} {ratio:9.4f}")
        for (op, kind), b in sorted(ops.items(),
                                    key=lambda kv: -kv[1])[:args.by_op]:
            print(f"    {op:28s} {kind:14s} {b:12.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
