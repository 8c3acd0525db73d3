"""The dry run's collectives: the spec pass of ``repro_torch.distributed.
spmd`` on tiny meta graphs with hand-computed answers, and on four
full-width cells against the JAX package's loop-aware count of the same
cell's partitioned HLO (``repro.launch.roofline.parse_hlo``).

The JAX side (``scripts/collectives_vs_jax.py --jax-cell``) lowers and
compiles as ``repro.launch.dryrun.run_cell`` does, in a subprocess with
512 placeholder CPU devices (``XLA_FLAGS=--xla_force_host_platform_
device_count=512 JAX_PLATFORMS=cpu``): this process never imports
``repro.launch.dryrun``, which sets ``XLA_FLAGS`` on import for every
child process started after it.  It compiles at
``--xla_backend_optimization_level=0``, which cuts the CPU backend's code
generation by about 40 % and leaves the partitioned HLO's collectives as
they are at the default level (the same bytes in all four cells).
Bytes are per chip: each collective's result bytes times its wire factor,
every executed loop trip counted; reduce-scatter counts with all-reduce.
A cell within 2x of JAX is held to 2x both ways; a cell that is not is
held to its measured factor (PERF.md names the HLO collectives behind
each such gap).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import config as TC
from repro_torch.distributed import spmd
from repro_torch.distributed.ctx import shard_act, use_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

ROOT = Path(__file__).resolve().parents[1]
_spec_vs = importlib.util.spec_from_file_location(
    "collectives_vs_jax", ROOT / "scripts" / "collectives_vs_jax.py")
VS = importlib.util.module_from_spec(_spec_vs)
_spec_vs.loader.exec_module(VS)          # imports nothing of JAX
MESH = Mesh(shape={"data": 2, "model": 4}, axis_names=("data", "model"),
            device=torch.device("meta"))
F32 = 4

# port / JAX of (total, all-gather, all-reduce[, all-to-all]) per cell:
# 2x both ways, or the cell's measured factor +-15% where it falls outside
WITHIN_2X = (0.5, 2.0)
GATE = {
    ("llama3_2_1b", "train_4k", "single"): {},
    ("llama3_2_1b", "train_4k", "multi"): {},
    # the port gathers decode's 128-token activations where XLA gathers
    # each FSDP weight block, and in bf16 where XLA's are fp32
    ("llama3_2_1b", "decode_32k", "single"): {"total": 0.4922,
                                              "all-gather": 0.4451},
    # XLA resolves the MoE dispatch and combine as masked gathers with
    # fp32 all-reduces of the [E*C/16, D] slot table, and all-gathers the
    # expert inputs over data; the port fetches each chip's rows
    ("olmoe_1b_7b", "train_4k", "single"): {"total": 0.1147,
                                            "all-gather": 0.1574,
                                            "all-reduce": 0.0591,
                                            "all-to-all": None},
}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _run(fn, tags):
    """``fn``'s ops on meta tensors under a spec pass on :data:`MESH`,
    ``tags`` [(tensor, spec)] its inputs' specs: (bytes, counts, out)."""
    sp = spmd.SpecPass({"m": MESH})
    for t, s in tags:
        sp.tag(t, [s])
    counter = dryrun.StepCounter(spmd=sp)
    with counter:
        out = fn()
    sp.finish(out)
    return sp.bytes["m"], sp.counts["m"], out


def _spec(t):
    tag = getattr(t, spmd.ATTR, None)
    return ((),) * t.dim() if tag is None else tag[0]


def test_contraction_over_a_sharded_dim_is_one_all_reduce():
    """[8, 16] @ [16, 32], the contracted dim on ``model`` in both: a
    partial sum, all-reduced: 2 x the replicated [8, 32] result."""
    x, w = _meta(8, 16), _meta(16, 32)
    b, c, y = _run(lambda: x @ w, [(x, (None, "model")),
                                   (w, ("model", None))])
    assert b == {"all-reduce": 2 * 8 * 32 * F32}
    assert c == {"all-reduce": 1}
    assert _spec(y) == ((), ())


def test_fsdp_weight_in_a_matmul_is_one_all_gather():
    """Activations [64, 16] over data; the weight [16, 8] over data on its
    input dim (FSDP) and model on its output dim: the weight's data
    blocks are gathered ([16, 8/4] fp32), the result keeps both axes."""
    x, w = _meta(64, 16), _meta(16, 8)
    b, c, y = _run(lambda: x @ w, [(x, ("data", None)),
                                   (w, ("data", "model"))])
    assert b == {"all-gather": 16 * 2 * F32}
    assert c == {"all-gather": 1}
    assert _spec(y) == (("data",), ("model",))


def test_residual_leaving_model_is_one_all_gather():
    """The residual [4, 8, 16] at (data, model, None): to unsharded, one
    all-gather of the whole tensor; through ``shard_act`` without
    sequence parallelism (data, None, None), one all-gather of the data
    block."""
    x = _meta(4, 8, 16)
    m = spmd._Mesh(0, dict(MESH.shape), [("data",), ("model",)])
    m.move(x, (("data",), ("model",), ()), ((), (), ()))
    assert m.ev == [("all-gather", 4 * 8 * 16 * F32)]

    sp = spmd.SpecPass({"m": MESH})
    sp.tag(x, [("data", "model", None)])
    with use_mesh(MESH, sequence_parallel=False) as ctx:
        sp.listen(ctx, sequence_parallel=False, long_context=False)
        assert shard_act(x, "residual") is x
    assert sp.bytes["m"] == {"all-gather": 4 * 8 * 16 * F32 / 2}
    assert sp.counts["m"] == {"all-gather": 1}
    assert _spec(x) == (("data",), (), ())


def test_moe_dispatch_is_an_all_to_all():
    """Rows of a token table [32, 16] sharded over data, fetched by
    indices every chip holds and laid out by the expert product that
    consumes them (experts over model): one all-to-all of each chip's
    block of the [4, 8, 16] result, none on the experts' side."""
    xt, idx, w = _meta(32, 16), torch.zeros(32, dtype=torch.long,
                                            device="meta"), _meta(4, 16, 8)
    b, c, y = _run(lambda: torch.bmm(xt[idx].view(4, 8, 16), w),
                   [(xt, ("data", None)), (w, ("model", None, None))])
    assert b == {"all-to-all": 4 * 8 * 16 * F32 / 8}
    assert c == {"all-to-all": 1}
    assert _spec(y) == (("model",), ("data",), ())


def test_partial_sums_accumulate_before_one_all_reduce():
    """Four [8, 16] @ [16, 32] products, each contracted over ``model``,
    summed in a loop and then read whole (``sigmoid``): the partial sums
    add up first and are all-reduced once, 2 x [8, 32]; an op that needs
    each product whole reduces each (4 x)."""
    xs, w = [_meta(8, 16) for _ in range(4)], _meta(16, 32)
    tags = [(x, (None, "model")) for x in xs] + [(w, ("model", None))]

    def summed():
        acc = xs[0] @ w
        for x in xs[1:]:
            acc = acc + x @ w
        return torch.sigmoid(acc)

    b, c, y = _run(summed, tags)
    assert b == {"all-reduce": 2 * 8 * 32 * F32}
    assert c == {"all-reduce": 1}
    assert _spec(y) == ((), ())
    b, c, _ = _run(lambda: [torch.sigmoid(x @ w) for x in xs], tags)
    assert b == {"all-reduce": 4 * 2 * 8 * 32 * F32}
    assert c == {"all-reduce": 4}


def test_memo_keys_carry_the_input_specs():
    """One matmul's shapes under two specs (the first twice): two memo
    entries, each with its own collective (model on both contracted dims:
    2 x [8, 32] a call; model on the weight's alone, the rows over data:
    the cheaper partial sum, 2 x [8/2, 32])."""
    x1, x2, w = _meta(8, 16), _meta(8, 16), _meta(16, 32)
    sp = spmd.SpecPass({"m": MESH})
    sp.tag(x1, [(None, "model")])
    sp.tag(x2, [("data", None)])
    sp.tag(w, [("model", None)])
    counter = dryrun.StepCounter(spmd=sp)
    with counter:
        outs = x1 @ w, x2 @ w, x1 @ w
    sp.finish(outs)
    assert len(counter._memo) == 2
    assert sp.bytes["m"] == {"all-reduce": (2 * 2 * 8 * 32 + 2 * 4 * 32)
                             * F32}
    assert sp.counts["m"] == {"all-reduce": 3}


def test_one_trace_gives_each_mesh_its_own_collectives(monkeypatch):
    """A reduced llama train step traced once: both production meshes'
    records carry all-gather and all-reduce bytes, and they differ (the
    multi-pod mesh halves each chip's batch)."""
    traces = []
    real = dryrun.trace_step
    monkeypatch.setattr(dryrun, "trace_step",
                        lambda *a, **k: traces.append(k) or real(*a, **k))
    cfg = TC.get_arch("llama3_2_1b").reduced()
    recs = dryrun.cell_records(cfg, TC.ShapeConfig("small_train", 48, 32,
                                                   "train"), "llama3_2_1b")
    assert len(traces) == 1 and set(traces[0]["meshes"]) == {"single",
                                                             "multi"}
    single, multi = (recs[m]["collective_bytes"] for m in ("single", "multi"))
    for coll in (single, multi):
        assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert single != multi
    assert recs["single"]["collective_unruled"] == {}


@pytest.mark.parametrize("arch,shape,mesh", list(GATE))
def test_collectives_near_jax_loop_aware_count(arch, shape, mesh):
    jax_b = VS.by_kind(VS.finish_jax(VS.start_jax(arch, shape, mesh)))
    rec = dryrun.run_cell(arch, shape, mesh)
    assert rec["status"] == "OK" and rec["collective_unruled"] == {}
    port = VS.by_kind(rec["collective_bytes"])
    gate = GATE[(arch, shape, mesh)]
    kinds = ["total", "all-gather", "all-reduce"] + (
        ["all-to-all"] if "all-to-all" in gate else [])
    for kind in kinds:
        ratio = port[kind] / jax_b[kind]
        measured = gate.get(kind)
        lo, hi = WITHIN_2X if measured is None else (0.85 * measured,
                                                      1.15 * measured)
        assert lo <= ratio <= hi, (kind, ratio, port[kind], jax_b[kind])
    assert sum(rec["collective_counts"].values()) > 0
