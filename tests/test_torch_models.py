"""The port's dense transformer against the JAX package's, on the CPU.

Reduced llama3.2-1b, qwen3-4b (qk-norm) and olmo-1b (non-parametric
LayerNorm) get the JAX weights through ``params_from_numpy``; forward,
``prefill`` and ``decode_step`` logits must agree at atol = rtol = 5e-3,
the tolerance of ``tests/test_models_smoke.py``.  The decode path keeps
its attention probabilities in fp32 where the JAX model rounds them to the
cache's bf16 before the PV product — the one documented difference,
inside that tolerance.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.config import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.models.registry import get_model as j_get_model

from repro_torch.config import MoEConfig, get_arch
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model, params_from_numpy

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    bounded_jax_maps, fresh_jax_caches,
)

ARCHS = ["llama3_2_1b", "qwen3_4b", "olmo_1b"]
TOL = dict(atol=5e-3, rtol=5e-3)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = j_get_arch(arch).reduced()
        cfg = get_arch(arch).reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jp = j_get_model(jcfg).init(jcfg, jax.random.key(1))
        out[arch] = (jcfg, cfg, jp,
                     params_from_numpy(cfg, jax.device_get(jp), "cpu"))
    return out


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(models, arch):
    jcfg, cfg, jp, tp = models[arch]
    rng = np.random.default_rng(0)
    B, S, Smax = 2, 8, 12
    toks = rng.integers(0, cfg.vocab, (B, S + 3)).astype(np.int32)
    jl, _ = JT.forward_train(jcfg, jp, jnp.asarray(toks[:, :S]))
    tl, aux = TT.forward_train(cfg, tp, toks[:, :S])
    assert tl.shape == (B, S, cfg.vocab) and float(aux["aux_loss"]) == 0
    _close(tl, jl)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks[:, :S]), Smax)
    tl, tc = TT.prefill(cfg, tp, toks[:, :S], Smax)
    _close(tl, jl)
    assert tc["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, Smax,
                             cfg.resolved_head_dim)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tc[name].float().numpy(), np.asarray(jc[name], np.float32),
            atol=1e-2, rtol=1e-2)     # one bf16 ulp where fp32 rounds apart
    # three teacher-forced decode steps on ragged lengths, from the prefill
    lens = np.array([S, S - 3], np.int32)
    for t in range(3):
        nt = toks[:, S + t]
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(nt), jc,
                                jnp.asarray(lens))
        tl, tc = TT.decode_step(cfg, tp, nt, tc, lens)
        _close(tl, jl)
        lens = lens + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_step_decode(models, arch):
    """Prefill + decode gives the step-by-step decode's logits, and the
    last step equals the forward's last position."""
    _, cfg, _, tp = models[arch]
    rng = np.random.default_rng(1)
    B, S = 2, 8
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    full, _ = TT.forward_train(cfg, tp, toks)
    api = get_model(cfg)
    cache = api.init_cache(cfg, B, S + 2, device="cpu")
    lens = np.zeros(B, np.int32)
    steps = []
    for t in range(S):
        lg, cache = api.decode_step(cfg, tp, toks[:, t], cache, lens)
        steps.append(lg)
        lens = lens + 1
    np.testing.assert_allclose(steps[-1].numpy(), full[:, -1].numpy(), **TOL)
    pl, pc = TT.prefill(cfg, tp, toks[:, :S - 2], S + 2)
    lens = np.full(B, S - 2, np.int32)
    lg, pc = TT.decode_step(cfg, tp, toks[:, S - 2], pc, lens)
    np.testing.assert_allclose(lg.numpy(), steps[S - 2].numpy(), **TOL)
    lg, _ = TT.decode_step(cfg, tp, toks[:, S - 1], pc, lens + 1)
    np.testing.assert_allclose(lg.numpy(), steps[S - 1].numpy(), **TOL)


def test_decode_at_a_full_cache_drops_the_write_like_jax(models):
    """lengths == Smax: JAX drops the out-of-range cache write and attends
    to the whole cache; the port does the same instead of raising."""
    jcfg, cfg, jp, tp = models["llama3_2_1b"]
    rng = np.random.default_rng(2)
    Smax = 6
    toks = rng.integers(0, cfg.vocab, (2, Smax)).astype(np.int32)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks), Smax)
    tl, tc = TT.prefill(cfg, tp, toks, Smax)
    lens = np.array([Smax, Smax - 1], np.int32)
    nt = np.array([5, 9], np.int32)
    jl, jc2 = JT.decode_step(jcfg, jp, jnp.asarray(nt), jc, jnp.asarray(lens))
    tl, tc2 = TT.decode_step(cfg, tp, nt, tc, lens)
    _close(tl, jl)
    assert torch.equal(tc2["k"][:, 0], tc["k"][:, 0])     # write dropped
    assert not torch.equal(tc2["k"][:, 1], tc["k"][:, 1])


def test_windowed_decode_raises_and_registry_guards(models):
    _, cfg, _, tp = models["llama3_2_1b"]
    lp = TT.layer_params(tp, 0)
    cache = TT.init_cache(cfg, 1, 4, device="cpu")
    x = torch.zeros(1, 1, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TC.attention_decode(cfg, lp["attn"], x, cache["k"][0],
                            cache["v"][0], torch.zeros(1, dtype=torch.int32),
                            window=4)
    moe = dataclasses.replace(cfg, moe=MoEConfig(n_experts=4, top_k=2,
                                                 d_expert=8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(moe)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(dataclasses.replace(cfg, encoder_only=True))
    windowed = dataclasses.replace(cfg, window=3, global_every=2,
                                   n_layers=4)
    assert TT.layer_windows(windowed).tolist() == [3, 0, 3, 0]


def test_params_layout_and_seeded_init(models):
    jcfg, cfg, jp, tp = models["qwen3_4b"]
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jax.device_get(jp))

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) \
            else tuple(t.shape)
    p1 = TT.init(cfg, torch.Generator().manual_seed(3))
    p2 = TT.init(cfg, torch.Generator().manual_seed(3))
    assert shapes(tp) == jshapes == shapes(p1)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)))
    assert tp["layers"]["attn"]["wq"].dtype == torch.float32
    logits, _ = TT.forward_train(cfg, p1, np.zeros((1, 4), np.int32))
    assert torch.isfinite(logits).all()
