"""The port's transformer against the JAX package's, on the CPU.

Reduced llama3.2-1b, qwen3-4b (qk-norm), olmo-1b (non-parametric
LayerNorm) and gemma3-1b (head_dim != d_model / n_heads, one kv head,
gelu, embedding scaling, and a sliding window of 8 on its local layer:
``global_every=2`` on both sides, so the two reduced layers are one local
and one global), the MoE decoders olmoe-1b-7b and deepseek-moe-16b
(shared experts), the VLM internvl2-76b (forward with patches) and the
encoder-only hubert-xlarge (forward on frame embeddings, no causal mask),
the hybrid zamba2-2.7b (Mamba2 layers and a shared attention block) and
xlstm-350m (mLSTM and sLSTM blocks) get the JAX weights through ``params_from_numpy``; forward, ``prefill``
and ``decode_step`` logits must agree at atol = rtol = 5e-3, the
tolerance of ``tests/test_models_smoke.py``, and the MoE aux values at
1e-5.  The two recurrent families have no prefill: their decode steps
run from a zero cache, the caches compared at the same tolerance.
gemma3's
prompts are longer than its window, so prefill and decode both cut it.  The decode path keeps
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
from repro.models import common as JC
from repro.models import transformer as JT
from repro.models.registry import get_model as j_get_model

from repro_torch.config import MoEConfig, SSMConfig, XLSTMConfig, get_arch
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.models import zamba as TZ
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.optim.adamw import tree_leaves

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

ARCHS = ["llama3_2_1b", "qwen3_4b", "olmo_1b", "gemma3_1b"]
MOE = ["olmoe_1b_7b", "deepseek_moe_16b"]
OTHER = ["internvl2_76b", "hubert_xlarge"]
SSM = ["zamba2_2_7b", "xlstm_350m"]
TOL = dict(atol=5e-3, rtol=5e-3)
# prompt length S and cache length Smax: gemma3's prompt passes its
# reduced window of 8
SIZES = {"gemma3_1b": (12, 20)}


def _reduced(arch, get):
    cfg = get(arch).reduced()
    if cfg.window:     # reduced gemma3 has 2 local layers: make one global
        cfg = dataclasses.replace(cfg, global_every=2)
    return cfg


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS + MOE + OTHER + SSM:
        jcfg = _reduced(arch, j_get_arch)
        cfg = _reduced(arch, get_arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jp = j_get_model(jcfg).init(jcfg, jax.random.key(1))
        out[arch] = (jcfg, cfg, jp,
                     params_from_numpy(cfg, jax.device_get(jp), "cpu"))
    return out


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS + MOE)
def test_forward_prefill_decode_match_jax(models, arch):
    jcfg, cfg, jp, tp = models[arch]
    rng = np.random.default_rng(0)
    B, (S, Smax) = 2, SIZES.get(arch, (8, 12))
    toks = rng.integers(0, cfg.vocab, (B, S + 3)).astype(np.int32)
    jl, jaux = JT.forward_train(jcfg, jp, jnp.asarray(toks[:, :S]))
    tl, aux = TT.forward_train(cfg, tp, toks[:, :S])
    assert tl.shape == (B, S, cfg.vocab) and set(aux) == set(jaux)
    assert (float(aux["aux_loss"]) == 0) == (cfg.moe is None)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=1e-5,
                                   rtol=1e-5)
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


@pytest.mark.parametrize("arch", SSM)
def test_recurrent_forward_decode_match_jax(models, arch):
    """``forward_train``, then 12 teacher-forced decode steps from a zero
    cache on both sides: each step's logits and the final caches against
    JAX's, and the last step against the forward's last position (the
    recurrent form against the chunked one)."""
    jcfg, cfg, jp, tp = models[arch]
    japi, api = j_get_model(jcfg), get_model(cfg)
    rng = np.random.default_rng(6)
    B, S, Smax = 2, 12, 16
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jl, jaux = japi.forward_train(jcfg, jp, jnp.asarray(toks))
    tl, aux = api.forward_train(cfg, tp, toks)
    assert tl.shape == (B, S, cfg.vocab) and set(aux) == set(jaux)
    assert float(aux["aux_loss"]) == 0
    _close(tl, jl)
    j_dec = jax.jit(japi.decode_step, static_argnums=0)
    jc = japi.init_cache(jcfg, B, Smax)
    tc = api.init_cache(cfg, B, Smax, device="cpu")
    lens = np.zeros(B, np.int32)
    for t in range(S):
        jo, jc = j_dec(jcfg, jp, jnp.asarray(toks[:, t]), jc,
                       jnp.asarray(lens))
        to, tc = api.decode_step(cfg, tp, toks[:, t], tc, lens)
        _close(to, jo)
        lens = lens + 1
    jleaves = jax.tree.leaves(jax.device_get(jc))
    tleaves = [t.float().numpy() for t in tree_leaves(tc)]
    assert [a.shape for a in tleaves] == [a.shape for a in jleaves]
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a.astype(np.float32),
                                   np.asarray(b, np.float32), **TOL)
    np.testing.assert_allclose(to.numpy(), tl[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("arch", OTHER)
def test_vlm_and_encoder_forward_match_jax(models, arch):
    """internvl2: the projected patches before the text, causal over both
    (logits for NP + S rows); hubert: frame embeddings through
    ``in_norm``, no causal mask, an untied 504-class head."""
    jcfg, cfg, jp, tp = models[arch]
    rng = np.random.default_rng(5)
    B, S = 2, 8
    if cfg.encoder_only:
        emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        jl, _ = JT.forward_train(jcfg, jp, embeds=jnp.asarray(emb))
        tl, aux = TT.forward_train(cfg, tp, embeds=emb)
        # no causal mask: a change to the last frame moves the first row
        emb2 = emb.copy()
        emb2[:, -1] += 1.0
        tl2, _ = TT.forward_train(cfg, tp, embeds=emb2)
        assert not torch.allclose(tl[:, 0], tl2[:, 0])
        assert get_model(cfg).decode_step is None
    else:
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        pat = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.patch_dim)).astype(np.float32)
        jl, _ = JT.forward_train(jcfg, jp, jnp.asarray(toks),
                                 patches=jnp.asarray(pat))
        tl, aux = TT.forward_train(cfg, tp, toks, patches=pat)
        S += cfg.vlm.n_patches
    assert tl.shape == (B, S, cfg.vocab) and float(aux["aux_loss"]) == 0
    _close(tl, jl)


def _old_init(cfg, gen):
    """The dense ``init`` before its repair: every layer drawn as its own
    tensors, then ``torch.stack``ed (two copies of the layers at once)."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    dev = gen.device
    params = {"tok": TC.init_embed(cfg, gen)}
    params["layers"] = stack([{
        "ln1": TC.init_norm(cfg, cfg.d_model, dev),
        "attn": TC.init_attention(cfg, gen),
        "ln2": TC.init_norm(cfg, cfg.d_model, dev),
        "mlp": TC.init_mlp(cfg, gen),
    } for _ in range(cfg.n_layers)])
    params["ln_f"] = TC.init_norm(cfg, cfg.d_model, dev)
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_init_gives_the_stacked_layers_bit_for_bit(arch):
    """``init`` allocates each [L, ...] tensor once and copies each layer
    in: the same seeded dense weights, leaf for leaf and bit for bit, as
    the stacking it replaced, at 3 layers and full vocabulary width."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=3)
    new = TT.init(cfg, torch.Generator().manual_seed(9))
    old = _old_init(cfg, torch.Generator().manual_seed(9))
    a, b = jax.tree_util.tree_flatten_with_path(new), \
        jax.tree_util.tree_flatten_with_path(old)
    assert a[1] == b[1]
    for (path, x), (_, y) in zip(a[0], b[0]):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_step_decode(models, arch):
    """Prefill + decode gives the step-by-step decode's logits, and the
    last step equals the forward's last position.  (Dense only: a MoE
    layer's capacity depends on how many tokens a call routes.)"""
    _, cfg, _, tp = models[arch]
    rng = np.random.default_rng(1)
    B, S = 2, SIZES.get(arch, (8, 12))[0]
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


def test_windowed_decode_at_a_full_cache_matches_jax(models):
    """lengths == Smax with a window: the write is dropped and the token
    sees the window's last ``window - 1`` rows, as the JAX mask keeps
    (``kpos > Smax - window``); beside it a row at Smax - 1."""
    jcfg, cfg, jp, tp = models["gemma3_1b"]
    rng = np.random.default_rng(3)
    Smax = 10
    toks = rng.integers(0, cfg.vocab, (2, Smax)).astype(np.int32)
    _, jc = JT.prefill(jcfg, jp, jnp.asarray(toks), Smax)
    _, tc = TT.prefill(cfg, tp, toks, Smax)
    lens = np.array([Smax, Smax - 1], np.int32)
    nt = np.array([5, 9], np.int32)
    for _ in range(2):
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(nt), jc,
                                jnp.asarray(lens))
        tl, tc = TT.decode_step(cfg, tp, nt, tc, lens)
        _close(tl, jl)
        lens = np.minimum(lens + 1, Smax)


def test_windowed_decode_raises_and_registry_guards(models):
    """Windowed decode no longer raises: ``attention_decode`` with a
    window matches the JAX one at lengths 0, inside the window, past it
    and at a full cache.  The registry resolves every family as the JAX
    registry does: the transformer's API for MoE, VLM and the encoder,
    zamba's for the hybrid config and xLSTM's for the recurrent one."""
    jcfg, cfg, jp, tp = models["gemma3_1b"]
    lp = TT.layer_params(tp, 0)["attn"]
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    rng = np.random.default_rng(4)
    B, Smax, hd = 4, 9, cfg.resolved_head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, cfg.n_kv_heads, Smax, hd))
              .astype(np.float32) for _ in range(2))
    lens = np.array([0, 3, 7, Smax], np.int32)
    for window in (4, 1, 12):
        jo, jk, _ = JC.attention_decode(
            jcfg, jlp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(lens), window=window)
        to, tk, _ = TC.attention_decode(
            cfg, lp, torch.from_numpy(x), torch.from_numpy(ck),
            torch.from_numpy(cv), torch.from_numpy(lens), window=window)
        if window == 1:   # at Smax no row is left: JAX averages all rows
            to, jo = to[:3], jo[:3]
        _close(to, jo)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    _, cfg, _, _ = models["llama3_2_1b"]
    moe = dataclasses.replace(cfg, moe=MoEConfig(n_experts=4, top_k=2,
                                                 d_expert=8))
    assert get_model(moe).decode_step is TT.decode_step
    for arch in MOE + OTHER:
        api = get_model(models[arch][1])
        assert api.forward_train is TT.forward_train
        enc = arch == "hubert_xlarge"
        assert (api.decode_step is None) == enc == (api.init_cache is None)
    hybrid = get_model(models["zamba2_2_7b"][1])
    assert (hybrid.forward_train, hybrid.decode_step, hybrid.init_cache) \
        == (TZ.forward_train, TZ.decode_step, TZ.init_cache)
    rec = get_model(models["xlstm_350m"][1])
    assert (rec.forward_train, rec.decode_step, rec.init_cache) \
        == (TX.forward_train, TX.decode_step, TX.init_cache)
    assert get_model(dataclasses.replace(
        cfg, hybrid_attn_every=2, ssm=SSMConfig())).init is TZ.init
    assert get_model(dataclasses.replace(
        cfg, xlstm=XLSTMConfig())).init is TX.init
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
