"""The port's dry run and roofline against the JAX package.

``model_params`` / ``model_flops`` equal JAX's exactly for every (arch,
shape) at full width (the parameter trees are ``meta`` tensors).  The
dry run's records, on each family's ``cfg.reduced()`` at small shapes
and on both production meshes: status OK, per-chip argument bytes equal
to those JAX's own specs give the same tensors, counted FLOPs at least
0.99 x ``model_flops``.  The attention wrappers' shape-only operators on
meta count the kernels' work (causal, windowed, decode) and raise the
kernels' errors; ``analyze_cell`` names a bottleneck and, from the
spec pass's collectives, a nonzero collective term on every train cell.
Full-width traces run in ``chip_smoke.py`` (phases ``dryrun`` and
``roofline``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_port import fresh_jax_caches  # noqa: F401  (autouse fixture)
from repro import config as JC
from repro.distributed import sharding as JS
from repro.launch import roofline as JRL
from repro.models import registry as JR
from repro.optim import adamw as JA
from repro_torch import config as TC
from repro_torch.kernels import _build
from repro_torch.kernels._meta import unmasked_pairs
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention,
)
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_bwd,
)
from repro_torch.launch import dryrun, roofline

pytest_plugins = ["_jax_maps"]

FAMILIES = ("llama3_2_1b", "gemma3_1b", "olmoe_1b_7b", "internvl2_76b",
            "hubert_xlarge", "zamba2_2_7b", "xlstm_350m")
SMALL = {"train": (48, 32), "prefill": (32, 32), "decode": (320, 32)}
JMESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
           "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_model_params_and_flops_match_jax(arch):
    jcfg, tcfg = JC.get_arch(arch), TC.get_arch(arch)
    assert roofline.model_params(tcfg) == JRL.model_params(jcfg)
    for sid, shape in JC.SHAPES.items():
        assert roofline.model_flops(tcfg, TC.SHAPES[sid]) == \
            JRL.model_flops(jcfg, shape), sid


def _small(cfg, kind):
    S, B = SMALL[kind]
    if cfg.vlm is not None and kind != "decode":
        S += cfg.vlm.n_patches
    return TC.ShapeConfig(f"small_{kind}", S, B, kind)


def _jax_arg_bytes(jcfg, shape, mesh) -> int:
    """Per-chip bytes of a step's arguments by JAX's own specs: the
    parameters (and, training, AdamW's two moments and the two step
    counters) and the inputs."""
    def local(leaf, spec):
        n = np.dtype(leaf.dtype).itemsize
        for d, e in zip(leaf.shape, tuple(spec) + (None,) * len(leaf.shape)):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            k = int(np.prod([mesh.shape[a] for a in axes]))
            assert d % k == 0
            n *= d // k
        return n

    pol = JS.ShardingPolicy(fsdp=True, sequence_parallel=jcfg.sequence_parallel)
    params = JR.param_shapes(jcfg)
    p_bytes = sum(
        local(leaf, JS.param_spec("/".join(str(k.key) for k in path),
                                  leaf.shape, mesh, pol))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0])
    batch = JR.input_specs(jcfg, shape)
    specs = JS.batch_specs(batch, mesh)
    b_bytes = sum(local(l, s) for l, s in zip(
        jax.tree_util.tree_leaves(batch), jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    if shape.kind != "train":
        return p_bytes + b_bytes
    opt = jax.eval_shape(JA.init, params)
    assert all(l.dtype == np.float32 for l in jax.tree_util.tree_leaves(
        opt.m))
    return 3 * p_bytes + 2 * 4 + b_bytes       # fp32 params, m, v; steps


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_reduced_both_meshes(arch):
    tcfg = TC.get_arch(arch).reduced()
    jcfg = JC.get_arch(arch).reduced()
    assert tcfg.param_dtype == "float32"
    for kind in ("train", "prefill", "decode"):
        shape = _small(tcfg, kind)
        if not TC.shape_applicable(tcfg, shape)[0] or (
                kind == "decode" and tcfg.encoder_only):
            continue
        recs = dryrun.cell_records(tcfg, shape, arch)
        jshape = JC.ShapeConfig(shape.name, shape.seq_len,
                                shape.global_batch, kind)
        mf = roofline.model_flops(tcfg, shape)
        for m, rec in recs.items():
            assert rec["status"] == "OK"
            assert rec["n_chips"] == (256 if m == "single" else 512)
            ma = rec["memory_analysis"]
            assert ma["argument_size_in_bytes"] == _jax_arg_bytes(
                jcfg, jshape, JMESHES[m]), (kind, m)
            assert ma["temp_size_in_bytes"] > 0
            assert ma["output_size_in_bytes"] > 0
            assert rec["global"]["flops"] >= 0.99 * mf, (kind, m)
            assert rec["cost_analysis"]["flops"] == \
                rec["global"]["flops"] / rec["n_chips"]
            coll = rec["collective_bytes"]
            assert rec["fits"] and rec["collective_unruled"] == {}
            assert set(coll) == set(rec["collective_counts"])
            if kind == "train":
                assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
            assert "residual" in rec["activations"] or kind == "decode"
            row = roofline.analyze_cell(rec, tcfg, shape)
            assert row["bottleneck"] in ("compute", "memory", "collective")
            assert row["t_collective_s"] == pytest.approx(
                sum(coll.values()) / roofline.NVLINK_BW)
            assert row["t_collective_s"] > 0 or kind != "train"
            assert 0 < row["useful_ratio"] <= 1.01


def test_run_cell_skips_with_jax_reason():
    rec = dryrun.run_cell("hubert_xlarge", "decode_32k", "multi")
    assert rec["status"] == "SKIP"
    assert rec["reason"] == JC.shape_applicable(
        JC.get_arch("hubert_xlarge"), JC.SHAPES["decode_32k"])[1]


def _count(fn):
    counter = dryrun.StepCounter()
    with counter:
        out = fn()
    return counter, out


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_meta_attention_counts_the_kernels_work(causal, window):
    B, H, KVH, S, D = 2, 8, 2, 70, 64
    q, k, v = _meta(B, H, S, D), _meta(B, KVH, S, D), _meta(B, KVH, S, D)
    mask = np.ones((S, S), bool)
    qi, ki = np.arange(S)[:, None], np.arange(S)[None, :]
    if causal:
        mask &= qi >= ki
    if window:
        mask &= qi - ki < window
    pairs = int(mask.sum())
    assert unmasked_pairs(S, S, causal, window) == pairs
    before = dict(_build.launch_counts)
    c, (o, lse) = _count(lambda: flash_attention(
        q, k, v, causal=causal, window=window, return_lse=True))
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == (
        q.shape, q.dtype, (B, H, S), torch.float32)
    fwd = 4 * B * H * D * pairs
    assert c.flops == fwd
    # q, k, v read once; out and lse written once
    assert c.bytes == ((B * H * S * D + 2 * B * KVH * S * D) * 2
                       + B * H * S * D * 2 + B * H * S * 4)
    c, grads = _count(lambda: flash_attention_bwd(
        q, k, v, o, lse, _meta(B, H, S, D), causal=causal, window=window))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert c.flops == 5 * fwd // 2
    assert dict(_build.launch_counts) == before     # nothing launched


def test_meta_decode_counts_cache_rows_and_refuses_bad_gqa():
    B, H, KVH, S, D = 4, 32, 8, 512, 64
    c, out = _count(lambda: decode_attention(
        _meta(B, H, D), _meta(B, KVH, S, D), _meta(B, KVH, S, D),
        _meta(B, dtype=torch.int32), starts=_meta(B, dtype=torch.int32)))
    assert out.shape == (B, H, D)
    assert c.flops == 4 * B * H * S * D
    # every input read once, out, m and l written once
    assert c.bytes == (B * H * D * 2 + 2 * B * KVH * S * D * 2 + 2 * B * 4
                       + B * H * D * 2 + 2 * B * H * 4)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(_meta(1, 6, 8, 16), _meta(1, 4, 8, 16),
                        _meta(1, 4, 8, 16))
    with pytest.raises(ValueError, match="H % KVH"):
        decode_attention(_meta(1, 6, 16), _meta(1, 4, 8, 16),
                         _meta(1, 4, 8, 16), _meta(1, dtype=torch.int32))


def test_counter_memo_matches_fresh_dispatch():
    """A repeated op (the memo's outputs) counts and shapes as the first."""
    x, w = _meta(64, 128), _meta(128, 32)
    c, outs = _count(lambda: [torch.sigmoid(x @ w) for _ in range(3)])
    assert c.flops == 3 * 2 * 64 * 128 * 32
    assert c.ops == 6 and len(c._memo) == 2
    assert all(o.shape == (64, 32) and o.dtype == torch.bfloat16
               for o in outs)
    assert c.bytes == 3 * ((64 * 128 + 128 * 32 + 64 * 32) * 2
                           + 2 * 64 * 32 * 2)
    assert c.peak >= 64 * 32 * 2 * 3


def test_dryrun_allocates_nothing_off_meta():
    rec = dryrun.cell_records(TC.get_arch("llama3_2_1b").reduced(),
                              _small(TC.get_arch("llama3_2_1b"), "train"),
                              "llama3_2_1b", ("single",))["single"]
    assert rec["device"] == "meta" and rec["status"] == "OK"
    assert not torch.cuda.is_initialized()


def test_vlm_prefill_reduced_sees_patches():
    cfg = TC.get_arch("internvl2_76b").reduced()
    rec = dryrun.cell_records(cfg, _small(cfg, "prefill"), "internvl2_76b",
                              ("single",))["single"]
    # the logits cover the patch rows too
    assert rec["activations"]["residual"]["shape"][1] == \
        SMALL["prefill"][0] + cfg.vlm.n_patches
