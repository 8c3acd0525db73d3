"""The port's shape table, abstract parameters and inputs, sharding rules
and activation context against the JAX package's, at full width.

``SHAPES``, ``ARCH_IDS`` and ``shape_applicable`` (values and reasons);
``param_shapes`` (meta tensors) against JAX's ``param_shapes``
(``jax.eval_shape``): the same key paths, shapes and dtypes, for every
architecture; ``input_specs`` likewise for every applicable cell, decode
caches included; ``param_spec`` and ``batch_specs`` entry for entry
against JAX's ``PartitionSpec``s on ``AbstractMesh``es of 16 x 16,
2 x 16 x 16 and 2 x 2, with FSDP and long context on and off;
``ShardCtx.spec`` and ``_guard`` for every kind, as
``tests/test_ctx_sharding.py`` holds the JAX ones.  Nothing here
allocates a full-width tensor: the port's trees live on ``meta``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from _torch_port import fresh_jax_caches  # noqa: F401  (autouse fixture)
from repro import config as JC
from repro.distributed import ctx as JX
from repro.distributed import sharding as JS
from repro.models import registry as JR
from repro_torch import config as TC
from repro_torch.distributed import ctx as TX
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import registry as TR

pytest_plugins = ["_jax_maps"]

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}


def _meshes(name):
    sizes, axes = MESHES[name]
    return (AbstractMesh(sizes, axes),
            Mesh(shape=dict(zip(axes, sizes)), axis_names=axes,
                 device=torch.device("meta")))


def _jax_leaves(tree):
    """{path: (shape, dtype name)} of a JAX tree, path as the JAX rules
    name it."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree):
    out = {}
    TS.tree_map_with_path(lambda path, t: out.__setitem__(
        "/".join(path), (tuple(t.shape), str(t.dtype).replace("torch.", ""))),
        tree)
    return out


def test_shape_table_matches_jax():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert set(TC.SHAPES) == set(JC.SHAPES)
    for k, s in JC.SHAPES.items():
        t = TC.SHAPES[k]
        assert (t.name, t.seq_len, t.global_batch, t.kind) == (
            s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_shape_applicable_matches_jax(arch):
    jcfg, tcfg = JC.get_arch(arch), TC.get_arch(arch)
    for sid in JC.SHAPES:
        assert (TC.shape_applicable(tcfg, TC.SHAPES[sid])
                == JC.shape_applicable(jcfg, JC.SHAPES[sid])), sid


def test_shape_applicable_counts():
    pairs = [(a, s) for a in TC.ARCH_IDS for s in TC.SHAPES]
    ok = [p for p in pairs
          if TC.shape_applicable(TC.get_arch(p[0]), TC.SHAPES[p[1]])[0]]
    assert (len(pairs), len(ok)) == (40, 32)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_shapes_match_jax(arch):
    tree = TR.param_shapes(TC.get_arch(arch))
    assert all(t.device.type == "meta" for t in
               _leaves(tree)), "param_shapes allocated off meta"
    assert _port_leaves(tree) == _jax_leaves(
        JR.param_shapes(JC.get_arch(arch)))


def _leaves(tree):
    out = []
    TS.tree_map_with_path(lambda _, t: out.append(t), tree)
    return out


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_input_specs_match_jax(arch):
    jcfg, tcfg = JC.get_arch(arch), TC.get_arch(arch)
    n = 0
    for sid, shape in JC.SHAPES.items():
        if not JC.shape_applicable(jcfg, shape)[0]:
            continue
        got = TR.input_specs(tcfg, TC.SHAPES[sid])
        assert all(t.device.type == "meta" for t in _leaves(got))
        assert _port_leaves(got) == _jax_leaves(
            JR.input_specs(jcfg, shape)), sid
        n += 1
    assert n >= 2


def _port_param_specs(tree, mesh, policy):
    return {"/".join(p): s for p, s in _flat_specs(
        TS.param_shardings(tree, mesh, policy), tree)}


def _flat_specs(specs, like, path=()):
    """(path, spec) at every tensor of ``like`` (specs are tuples too)."""
    if isinstance(like, dict):
        for k, v in like.items():
            yield from _flat_specs(specs[k], v, path + (str(k),))
    elif isinstance(like, (tuple, list)):
        for i, (s, v) in enumerate(zip(specs, like)):
            yield from _flat_specs(s, v, path + (str(i),))
    else:
        yield path, specs


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_specs_match_jax(arch):
    jtree = JR.param_shapes(JC.get_arch(arch))
    ttree = TR.param_shapes(TC.get_arch(arch))
    sharded = 0
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        for fsdp in (True, False):
            jp = JS.ShardingPolicy(fsdp=fsdp)
            tp = TS.ShardingPolicy(fsdp=fsdp)
            want = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
                key = "/".join(str(getattr(k, "key", k)) for k in path)
                want[key] = tuple(JS.param_spec(key, leaf.shape, jmesh, jp))
            got = _port_param_specs(ttree, tmesh, tp)
            assert got == want, (name, fsdp)
            sharded += sum(any(e is not None for e in s)
                           for s in got.values())
    assert sharded > 0


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_batch_specs_match_jax(arch):
    jcfg, tcfg = JC.get_arch(arch), TC.get_arch(arch)
    for sid, shape in JC.SHAPES.items():
        if not JC.shape_applicable(jcfg, shape)[0]:
            continue
        jb = JR.input_specs(jcfg, shape)
        tb = TR.input_specs(tcfg, TC.SHAPES[sid])
        for name in MESHES:
            jmesh, tmesh = _meshes(name)
            for long_ctx in (False, True):
                want = {}
                specs = JS.batch_specs(jb, jmesh, long_context=long_ctx)
                for path, spec in jax.tree_util.tree_flatten_with_path(
                        specs, is_leaf=lambda x: isinstance(x, P))[0]:
                    key = "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                                 k)))
                                   for k in path)
                    want[key] = tuple(spec)
                got = {"/".join(p): s for p, s in _flat_specs(
                    TS.batch_specs(tb, tmesh, long_context=long_ctx), tb)}
                assert got == want, (sid, name, long_ctx)


def test_local_shape_divides_and_refuses():
    _, mesh = _meshes("2x16x16")
    assert TS.local_shape((64, 4096, 8), (("pod", "data"), "model", None),
                          mesh) == (2, 256, 8)
    assert TS.local_shape((5, 7), (None, None), mesh) == (5, 7)
    with pytest.raises(ValueError, match="does not divide"):
        TS.local_shape((33, 8), (("pod", "data"), None), mesh)


def test_production_meshes_match_jax():
    single, multi = (make_production_mesh(),
                     make_production_mesh(multi_pod=True))
    assert (single.shape, single.axis_names) == (
        {"data": 16, "model": 16}, ("data", "model"))
    assert (multi.shape, multi.axis_names) == (
        {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"))
    assert single.device.type == multi.device.type == "meta"


# ---------------------------------------------------------------------------
# the activation context (tests/test_ctx_sharding.py's cases, both sides)
# ---------------------------------------------------------------------------

class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
KINDS = ("residual", "tokens", "logits", "kv_cache", "ssm_state",
         "moe_tokens", "moe_experts", "moe_weight", "kv4", "seq_shard",
         "no_such_kind")


@pytest.mark.parametrize("kind", KINDS)
def test_ctx_spec_matches_jax(kind):
    for mesh in (MESH, POD, FakeMesh({"data": 2, "model": 2})):
        for sp in (True, False):
            for lc in (True, False):
                for ndim in (2, 3, 4, 5):
                    if kind == "ssm_state" and ndim < 3:
                        continue
                    j = JX.ShardCtx(mesh, sequence_parallel=sp,
                                    long_context=lc).spec(kind, ndim)
                    t = TX.ShardCtx(mesh, sequence_parallel=sp,
                                    long_context=lc).spec(kind, ndim)
                    assert t == (None if j is None else tuple(j)), (
                        kind, mesh.shape, sp, lc, ndim)


def test_kv4_and_guard_as_jax_tests_hold():
    ctx = TX.ShardCtx(MESH)
    assert ctx.spec("kv4", 4) == ("data", None, "model", None)
    assert TX.ShardCtx(MESH, long_context=True).spec("kv4", 4)[2] == (
        "data", "model")
    assert TX.ShardCtx(POD, long_context=True).spec("kv4", 4)[2] == (
        "pod", "data", "model")
    assert TX.ShardCtx(MESH, sequence_parallel=False).spec(
        "residual", 3) == ("data", None, None)
    cases = [(("data", None, "model", None), (24, 5, 2048, 64), MESH),
             ((("pod", "data"), None), (64, 8), POD),
             ((("pod", "data"), None), (33, 8), POD)]
    for spec, shape, mesh in cases:
        assert TX._guard(spec, shape, mesh) == tuple(
            JX._guard(P(*spec), shape, mesh))
    assert TX._guard(*cases[0]) == (None, None, "model", None)


def test_shard_act_noop_outside_and_records_inside():
    x = torch.zeros(4, 8)
    assert TX.shard_act(x, "residual") is x
    y = torch.zeros(32, 64, 8, device="meta")
    with TX.use_mesh(make_production_mesh()) as ctx:
        assert TX.shard_act(y, "residual") is y
        assert TX.shard_act(y, "no_such_kind") is y
    assert ctx.records == [("residual", (32, 64, 8), ("data", "model", None),
                            (2, 4, 8))]
    assert TX.shard_act(y, "residual") is y      # the context is gone
    with TX.use_mesh(None) as none:
        assert none is None and TX.shard_act(x, "logits") is x
