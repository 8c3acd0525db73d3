"""The port's training slice against the JAX package's, on the CPU.

Reduced llama3.2-1b (fp32 compute) from JAX-initialised parameters
carried across as numpy (``params_from_numpy``), the same batches
(``make_batch`` is bit-equal, ``tests/test_torch_data.py``) and the same
optimizer config on both sides.  Tolerances, each measured well inside:

  * ``cross_entropy``: 1e-6 (fp32, summation order);
  * one AdamW ``update`` on the same gradients: params, m, v within 1e-7,
    the fp32 schedule and bias corrections within 1 ulp;
  * the attention's gradient (``attention_bwd_ref`` and the autograd
    ``Function``) against ``jax.vjp`` of ``repro.models.common._sdpa``:
    2e-5 (fp32, the flash-attention tolerance of ``tests/test_kernels.py``);
  * train steps (loss, ``grad_norm``, parameters, moments): loss and norm
    within rtol 1e-5, parameters within atol 1e-6, the crash-restart
    tolerances of ``tests/test_checkpoint_fault.py``;
  * compression, the straggler monitor and checkpoints: exact.

Train checkpoints cross in both directions: the port's tree-path names
are the JAX manager's (35 of them for this config).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.checkpoint.manager import _flatten as j_flatten
from repro.config import get_arch as j_get_arch
from repro.data.pipeline import make_batch as j_make_batch
from repro.distributed.fault import StragglerMonitor as JMonitor
from repro.distributed.fault import run_with_restarts as j_restarts
from repro.models import common as JC
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import compression as JZ
from repro.train import steps as JS

from repro_torch.checkpoint.manager import CheckpointManager, _tree_flatten
from repro_torch.config import get_arch
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed.fault import StragglerMonitor, run_with_restarts
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_ref,
)
from repro_torch.launch import train as train_cli
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.registry import params_from_numpy, params_to_numpy
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TZ
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import loop as TL
from repro_torch.train import steps as TS

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

STEP_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(atol=1e-6, rtol=0)
OPT = dict(warmup_steps=2, total_steps=10)


def _cfgs(**over):
    jcfg = dataclasses.replace(j_get_arch("llama3_2_1b").reduced(), **over)
    cfg = dataclasses.replace(get_arch("llama3_2_1b").reduced(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _port_state(cfg, jstate) -> TS.TrainState:
    """A JAX train state carried across as numpy."""
    h = jax.device_get(jstate)
    params = params_from_numpy(cfg, h.params, "cpu")
    opt = TA.OptState(params_from_numpy(cfg, h.opt.m, "cpu"),
                      params_from_numpy(cfg, h.opt.v, "cpu"),
                      torch.tensor(np.asarray(h.opt.step)))
    return TS.TrainState(params, opt, torch.tensor(np.asarray(h.step)))


def _assert_tree_close(jtree, ttree, **tol):
    jl = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    tl = [x.detach().numpy() for x in tree_leaves(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, **tol)


@pytest.fixture(scope="module")
def jinit():
    jcfg, _ = _cfgs()
    return JS.init_state(jcfg, jax.random.key(0))


# ---------------------------------------------------------------------------
# loss, optimizer, attention gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)        # a few hits for acc
    mask = rng.random((3, 7)) < 0.7
    jl, jm = JC.cross_entropy(jnp.asarray(logits, dtype),
                              jnp.asarray(labels), jnp.asarray(mask))
    tl, tm = TC.cross_entropy(torch.tensor(logits).to(getattr(torch, dtype)),
                              torch.tensor(labels), torch.tensor(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("nll", "acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


def test_adamw_update_matches_jax(jinit):
    """One update on the same gradients, from a state with moments and a
    step already set: parameters, moments, lr, grad norm."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(5)
    jp = jinit.params
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), jp)
    m0 = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, jp)
    v0 = jax.tree.map(
        lambda p: rng.random(p.shape).astype(np.float32) * 0.01, jp)
    ocfg = JA.AdamWConfig(**OPT)
    jstate = JA.OptState(jax.tree.map(jnp.asarray, m0),
                         jax.tree.map(jnp.asarray, v0), jnp.int32(3))
    jnew, jopt, jmet = jax.jit(
        lambda p, g, s: JA.update(ocfg, p, g, s))(
            jp, jax.tree.map(jnp.asarray, grads), jstate)
    tp = params_from_numpy(cfg, jax.device_get(jp), "cpu")
    tstate = TA.OptState(params_from_numpy(cfg, m0, "cpu"),
                         params_from_numpy(cfg, v0, "cpu"),
                         torch.tensor(3, dtype=torch.int32))
    tnew, topt, tmet = TA.update(TA.AdamWConfig(**OPT), tp,
                                 params_from_numpy(cfg, grads, "cpu"),
                                 tstate)
    assert int(topt.step) == int(jopt.step) == 4
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                               rtol=1.2e-7)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    for j, t in ((jnew, tnew), (jopt.m, topt.m), (jopt.v, topt.v)):
        _assert_tree_close(j, t, atol=1e-7, rtol=0)
    for s in (0, 1, 2, 5, 9, 10, 40):
        np.testing.assert_allclose(
            float(TA.schedule(TA.AdamWConfig(**OPT),
                              torch.tensor(s, dtype=torch.int32))),
            float(JA.schedule(ocfg, jnp.int32(s))), rtol=1.2e-7)


@pytest.mark.parametrize("B,H,KVH,S,D,causal,win", [
    (2, 4, 2, 24, 8, True, 0),
    (1, 4, 1, 33, 16, True, 5),       # window, GQA 4:1
    (2, 4, 4, 20, 8, True, 3),
    (1, 8, 2, 17, 32, False, 0),      # no causal mask
])
def test_attention_grad_matches_jax_sdpa(B, H, KVH, S, D, causal, win):
    """``attention_bwd_ref`` and the autograd ``Function`` on CPU tensors
    against ``jax.vjp`` of the JAX models' attention."""
    rng = np.random.default_rng(S + D)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D),
                             (B, H, S, D)))
    jo, vjp = jax.vjp(lambda q, k, v: JC._sdpa(q, k, v, win, causal, D),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention(tq, tk, tv, causal=causal, window=win)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=2e-5, rtol=2e-5)
    o, lse = attention_ref(*(torch.tensor(a) for a in (q, k, v)),
                           causal=causal, window=win, return_lse=True)
    ref = attention_bwd_ref(*(torch.tensor(a) for a in (q, k, v)), o, lse,
                            torch.tensor(do), causal=causal, window=win)
    for t, r, j in zip((tq, tk, tv), ref, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(r.numpy(), np.asarray(j), atol=2e-5,
                                   rtol=2e-5)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _train_both(jcfg, cfg, jstate, n_steps: int, B: int = 2, S: int = 16):
    jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(**OPT)))
    tstep = TS.make_train_step(cfg, TA.AdamWConfig(**OPT))
    tstate = _port_state(cfg, jstate)
    for s in range(n_steps):
        jstate, jm = jstep(jstate, j_make_batch(jcfg, B, S, s))
        tstate, tm = tstep(tstate, make_batch(cfg, B, S, s, device="cpu"))
        for key in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       **STEP_TOL)
        assert float(tm["acc"]) == float(jm["acc"])
    return jstate, tstate


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(jinit, n_steps):
    jcfg, cfg = _cfgs()
    jstate, tstate = _train_both(jcfg, cfg, jinit, n_steps)
    assert int(tstate.step) == int(jstate.step) == n_steps
    _assert_tree_close(jstate.params, tstate.params, **PARAM_TOL)
    _assert_tree_close(jstate.opt, tstate.opt, **PARAM_TOL)


@pytest.mark.parametrize("over", [dict(accum_steps=2), dict(remat=False)],
                         ids=["accum2", "no_remat"])
def test_train_step_variants_match_jax(jinit, over):
    jcfg, cfg = _cfgs(**over)
    jstate, tstate = _train_both(jcfg, cfg, jinit, 2, B=4)
    _assert_tree_close(jstate.params, tstate.params, **PARAM_TOL)


def test_prefill_and_serve_steps_match_jax(jinit):
    jcfg, cfg = _cfgs()
    tp = params_from_numpy(cfg, jax.device_get(jinit.params), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)) \
        .astype(np.int32)
    jl = JS.make_prefill_step(jcfg)(jinit.params,
                                    {"tokens": jnp.asarray(toks)})
    tl = TS.make_prefill_step(cfg)(tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-3,
                               rtol=5e-3)
    _, jc = JT.prefill(jcfg, jinit.params, jnp.asarray(toks), 12)
    _, tc = TT.prefill(cfg, tp, toks, 12)
    lens = np.full(2, 8, np.int32)
    jo = JS.make_serve_step(jcfg)(jinit.params, {
        "tokens": jnp.asarray(toks[:, -1]), "cache": jc,
        "lengths": jnp.asarray(lens)})
    to = TS.make_serve_step(cfg)(tp, {
        "tokens": torch.tensor(toks[:, -1]), "cache": tc,
        "lengths": torch.tensor(lens)})
    np.testing.assert_array_equal(to["tokens"].numpy(),
                                  np.asarray(jo["tokens"]))
    np.testing.assert_array_equal(to["lengths"].numpy(), lens + 1)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(
        jo["logits"]), atol=5e-3, rtol=5e-3)


def test_trained_params_cross_back_to_jax(jinit):
    """Three port steps, then the JAX model on ``params_to_numpy`` of the
    result gives the port's logits."""
    jcfg, cfg = _cfgs()
    tstate = _port_state(cfg, jinit)
    step = TS.make_train_step(cfg, TA.AdamWConfig(**OPT))
    for s in range(3):
        tstate, _ = step(tstate, make_batch(cfg, 2, 16, s, device="cpu"))
    host = params_to_numpy(tstate.params)
    assert jax.tree.structure(host) == jax.tree.structure(
        jax.device_get(jinit.params))
    toks = make_batch(cfg, 2, 16, 7, device="cpu")["tokens"]
    with torch.no_grad():
        tl, _ = TT.forward_train(cfg, tstate.params, toks)
    jl, _ = JT.forward_train(jcfg, jax.tree.map(jnp.asarray, host),
                             jnp.asarray(toks.numpy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# crash-restart, straggler monitor, compression
# ---------------------------------------------------------------------------

def test_run_with_restarts_matches_jax(tmp_path):
    """Twelve steps with crashes at 6 and 10 (checkpoints every 4) give
    JAX's trajectory, replays included, and an uninterrupted run's."""
    jcfg, cfg = _cfgs()
    jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig()))
    tstep = TS.make_train_step(cfg, TA.AdamWConfig())

    def j_init():
        return JS.init_state(jcfg, jax.random.key(0))

    def t_init():
        return _port_state(cfg, j_init())

    run = dict(total_steps=12, ckpt_every=4)
    jstate, jhist = j_restarts(
        init_fn=j_init, step_fn=jstep,
        batch_fn=lambda s: j_make_batch(jcfg, 2, 16, s),
        ckpt=JCkpt(tmp_path / "jax", keep=3, async_write=False),
        crash_at=[6, 10], **run)
    hists = {}
    for name, crash in (("crash", [6, 10]), ("clean", [])):
        tstate, hists[name] = run_with_restarts(
            init_fn=t_init, step_fn=tstep,
            batch_fn=lambda s: make_batch(cfg, 2, 16, s, device="cpu"),
            ckpt=CheckpointManager(tmp_path / name, keep=3,
                                   async_write=False, device="cpu"),
            crash_at=crash, **run)
        _assert_tree_close(jstate.params, tstate.params, **PARAM_TOL)
    th = hists["crash"]
    assert [h[:2] for h in th] == [h[:2] for h in jhist]
    assert ("restart", 6, 4) in th and ("restart", 10, 8) in th
    for (_, _, a), (_, _, b) in zip(th, jhist):
        np.testing.assert_allclose(a, b, **STEP_TOL)
    clean = {s: l for k, s, l in hists["clean"] if k == "step"}
    for k, s, l in th:
        if k == "step":
            assert l == clean[s]            # a replay is bit-exact


def test_straggler_monitor_matches_jax():
    durations = [0.10 + 0.001 * (s % 7) for s in range(40)]
    durations[12], durations[30], durations[31] = 0.5, 0.9, 0.26
    jm, tm = JMonitor(factor=2.0, min_samples=4), \
        StragglerMonitor(factor=2.0, min_samples=4)
    hits = []
    tm.on_straggler(hits.append)
    for s, d in enumerate(durations):
        je, te = jm.record(s, d), tm.record(s, d)
        assert (je is None) == (te is None)
    assert [dataclasses.astuple(e) for e in tm.events] == \
        [dataclasses.astuple(e) for e in jm.events]
    assert hits == tm.events and len(hits) >= 2
    with tm.timed(99):
        pass
    assert len(tm.durations) == len(durations) + 1


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_compress_grads_matches_jax(kind):
    """Five rounds of error feedback: the sent gradients and the error
    buffers equal JAX's."""
    rng = np.random.default_rng(0)
    jcfg = JZ.CompressionConfig(kind=kind, topk_ratio=0.25)
    tcfg = TZ.CompressionConfig(kind=kind, topk_ratio=0.25)
    jerr = JZ.init_error({"w": jnp.zeros((32, 16)),
                          "b": {"c": jnp.zeros(40)}})
    terr = TZ.init_error({"w": torch.zeros(32, 16),
                          "b": {"c": torch.zeros(40)}})
    for _ in range(5):
        g = {"w": rng.standard_normal((32, 16)).astype(np.float32),
             "b": {"c": rng.standard_normal(40).astype(np.float32)}}
        jsent, jerr = JZ.compress_grads(jcfg, jax.tree.map(jnp.asarray, g),
                                        jerr)
        tsent, terr = TZ.compress_grads(
            tcfg, {"w": torch.tensor(g["w"]),
                   "b": {"c": torch.tensor(g["b"]["c"])}}, terr)
        _assert_tree_close(jsent, tsent, atol=0, rtol=0)
        _assert_tree_close(jerr, terr, atol=0, rtol=0)
    sent, err = TZ.compress_grads(TZ.CompressionConfig(), g, terr)
    assert sent is g and err is terr


# ---------------------------------------------------------------------------
# train checkpoints across the packages, the loop and the CLI
# ---------------------------------------------------------------------------

def test_train_checkpoint_names_are_jax(jinit):
    _, cfg = _cfgs()
    names = [n for n, _ in _tree_flatten(_port_state(cfg, jinit))]
    assert names == [n for n, _ in j_flatten(jax.device_get(jinit))]
    assert len(names) == 35
    assert {".params/layers/attn/wq", ".opt/.m/tok/embed", ".opt/.step",
            ".step"} <= set(names)


def test_train_checkpoint_jax_to_port(tmp_path, jinit):
    jcfg, cfg = _cfgs()
    jstate, _ = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(**OPT)))(
        jinit, j_make_batch(jcfg, 2, 16, 0))
    JCkpt(tmp_path, async_write=False).save(jstate, 5)
    mgr = CheckpointManager(tmp_path, device="cpu")
    assert mgr.latest_step() == 5
    like = TS.init_state(cfg, torch.Generator().manual_seed(1))
    got, step = mgr.restore(like)
    assert step == 5 and isinstance(got, TS.TrainState)
    _assert_tree_close(jstate, got, atol=0, rtol=0)
    assert got.step.dtype == torch.int32 and int(got.step) == 1


def test_train_checkpoint_port_to_jax(tmp_path, jinit):
    jcfg, cfg = _cfgs()
    tstate = _port_state(cfg, jinit)
    tstate, _ = TS.make_train_step(cfg, TA.AdamWConfig(**OPT))(
        tstate, make_batch(cfg, 2, 16, 0, device="cpu"))
    mgr = CheckpointManager(tmp_path, device="cpu")     # async write
    mgr.save(tstate, 3)
    mgr.wait()
    like = jax.eval_shape(lambda: JS.init_state(jcfg, jax.random.key(0)))
    got, step = JCkpt(tmp_path).restore(like)
    assert step == 3
    _assert_tree_close(got, tstate, atol=0, rtol=0)


def test_loop_resumes_from_its_checkpoint(tmp_path):
    """``train`` for 4 steps with checkpoints, then on to 6 from the
    checkpoint, equals 6 steps in one go; the loop's outputs are there."""
    _, cfg = _cfgs()
    opt = TA.AdamWConfig(**OPT)

    def loop(total, d):
        return TL.TrainLoopConfig(batch_size=2, seq_len=16,
                                  total_steps=total, log_every=2,
                                  ckpt_every=2, ckpt_dir=d)
    logs = []
    first = TL.train(cfg, loop(4, tmp_path / "a"), opt, log_fn=logs.append,
                     device="cpu")
    assert len(first["losses"]) == 4 and first["steps_per_s"] > 0
    resumed = TL.train(cfg, loop(6, tmp_path / "a"), opt,
                       log_fn=logs.append, device="cpu")
    assert "restored checkpoint at step 4" in logs
    assert len(resumed["losses"]) == 2
    whole = TL.train(cfg, loop(6, None), opt, log_fn=logs.append,
                     device="cpu")
    assert whole["losses"][4:] == resumed["losses"]
    for a, b in zip(tree_leaves(whole["state"]),
                    tree_leaves(resumed["state"])):
        assert torch.equal(a, b)
    assert isinstance(whole["straggler_events"], list)


def test_train_cli_on_cpu(capsys):
    train_cli.main(["--arch", "llama3_2_1b", "--reduced", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "done:" in capsys.readouterr().out


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(cfg, 2, 16, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.train(cfg, TL.TrainLoopConfig(total_steps=1))
