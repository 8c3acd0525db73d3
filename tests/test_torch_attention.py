"""The port's attention twins against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro.kernels.flash_attention`` /
``decode_attention`` (Pallas, interpret mode on the CPU, as
``tests/test_kernels.py`` runs them) and through the port's wrappers on
CPU tensors, which take the plain twins.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in fp32, 2e-2 in bf16.  The twins copy the
TPU kernels' edge conventions (a row with no unmasked key gives 0), which
the JAX oracle ``attention_ref`` does not; those rows are compared with
the kernel only.

Three tests carry the card kernels' designs where there is no card: plain
PyTorch emulations of the bf16 tensor-core flash kernel's roundings and
of its backward's, each held to the card's bf16 gate, and the split-KV
decode schedule with its combine held against the twin and the Pallas
kernel.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention as j_decode,
)
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention as j_flash,
)
from repro.kernels.flash_attention.ref import attention_ref as j_aref

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.decode_attention import (
    TARGET_BLOCKS, TILE_ROWS, _split_schedule, decode_attention,
)
from repro_torch.kernels.decode_attention.ops import decode
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_ref,
)

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

RNG = np.random.default_rng(7)
NEG_INF = -1e30
BF16_GATE = dict(atol=1e-5, rtol=2.0 ** -7)   # the card's bf16 gate
BWD_GATE_BF16 = 2e-2          # the card's bf16 backward gate, of max |grad|
SERVE_DECODE = (4, 32, 8, 512, 64)            # B, H, KVH, S, D (llama3.2-1b)
H100_SMS = 132


def _both(a, dtype):
    """(jax array, torch tensor) of one numpy array in ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()
    return jnp.asarray(a), torch.tensor(a)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KVH,S,D,causal,win,dtype", [
    (2, 4, 2, 96, 32, True, 0, "float32"),
    (2, 8, 4, 80, 32, True, 24, "float32"),
    (1, 4, 1, 64, 16, False, 0, "float32"),
    (1, 4, 2, 64, 32, True, 16, "bfloat16"),
])
def test_flash_twin_matches_pallas_kernel(B, H, KVH, S, D, causal, win,
                                          dtype):
    arrs = [RNG.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrs)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    n0 = sum(_build.launch_counts.values())
    got = attention(tq, tk, tv, causal=causal, window=win)
    assert sum(_build.launch_counts.values()) == n0   # the twin: no launch
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, j_flash(jq, jk, jv, causal=causal, window=win,
                        block_q=32, block_k=32), tol)
    _close(got, j_aref(jq, jk, jv, causal=causal, window=win), tol)


@pytest.mark.parametrize("B,H,KVH,S,D,bk", [
    (3, 8, 2, 100, 32, 32), (1, 8, 1, 130, 64, 64),
])
def test_decode_twin_matches_pallas_kernel(B, H, KVH, S, D, bk):
    q = RNG.standard_normal((B, H, D)).astype(np.float32)
    k = RNG.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = RNG.standard_normal((B, KVH, S, D)).astype(np.float32)
    lens = RNG.integers(1, S + 1, B).astype(np.int32)
    got = decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                 torch.tensor(lens))
    args = tuple(map(jnp.asarray, (q, k, v, lens)))
    _close(got, j_decode(*args, block_k=bk), 2e-5)
    _close(got, j_dref(*args), 2e-5)
    # bf16 inputs (the KV cache's type on the serve path)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.tensor(x).bfloat16() for x in (q, k, v)]
    got_b = decode_attention(*tb, torch.tensor(lens))
    assert got_b.dtype == torch.bfloat16
    _close(got_b, j_decode(*jb, jnp.asarray(lens), block_k=bk), 2e-2)


def _combine(parts):
    """The card's combine of per-split (out, m, l), fp32: m = max m_i,
    l = sum l_i e^{m_i - m}, out = sum acc_i e^{m_i - m} / (l or 1), with
    acc_i = out_i l_i and the empty splits (l_i = 0) left out."""
    o = torch.stack([p[0].float() for p in parts])
    m = torch.stack([p[1] for p in parts])
    l = torch.stack([p[2] for p in parts])
    mx = m.amax(0)
    w = torch.where(l > 0, torch.exp(m - mx), 0.0)
    lsum = (l * w).sum(0)
    out = (o * l * w).sum(0) / torch.where(lsum == 0, 1.0, lsum)
    return out, mx, lsum


@pytest.mark.parametrize("B,H,KVH,S,D,lens", [
    (2, 4, 2, 64, 16, (64, 64)),
    # the serve shape: 8 splits of 64; length 0 (every split empty), one
    # ending mid-chunk, one in the last chunk, one past S
    (4, 32, 8, 512, 64, (0, 100, 481, 700)),
    (3, 8, 2, 100, 32, (1, 33, 99)),
])
def test_decode_stats_split_kv_combine(B, H, KVH, S, D, lens):
    """The split-KV kernel's schedule and combine on the CPU: each split's
    (out, m, l) from the twin over its own rows (and the Pallas kernel's
    stats on the same rows), combined as the card combines them, equals
    the whole-cache twin and the Pallas kernel for out, m and l."""
    q = RNG.standard_normal((B, H, D)).astype(np.float32)
    k = RNG.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = RNG.standard_normal((B, KVH, S, D)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    full = decode_attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), torch.tensor(lens),
                            return_stats=True)
    j_full = j_decode(*map(jnp.asarray, (q, k, v, lens)), block_k=16,
                      return_stats=True)
    n_splits, chunk = _split_schedule(S, B * KVH)
    parts = []
    for i in range(n_splits):
        sl = slice(i * chunk, min((i + 1) * chunk, S))
        n_i = np.clip(np.minimum(lens, S) - i * chunk, 0, chunk)
        ks, vs = (np.ascontiguousarray(x[:, :, sl]) for x in (k, v))
        o, m, l = decode_attention(torch.tensor(q), torch.tensor(ks),
                                   torch.tensor(vs),
                                   torch.tensor(n_i.astype(np.int32)),
                                   return_stats=True)
        jo, jm, jl = j_decode(*map(jnp.asarray, (q, ks, vs,
                                                 n_i.astype(np.int32))),
                              block_k=16, return_stats=True)
        assert m.shape == l.shape == (B, H, 1)
        _close(o, jo, 2e-5)
        _close(m, jm, 2e-5)
        _close(l, jl, 2e-5)
        parts.append((o, m, l))
    got = _combine(parts)
    for g, w, j, tol in zip(got, full, j_full, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=tol)
        _close(g, j, tol)
    empty = lens == 0
    assert torch.all(got[0][empty] == 0) and torch.all(got[2][empty] == 0)
    assert torch.all(got[1][empty] == NEG_INF)


@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 100, 130, 512, 4096,
                               32768])
@pytest.mark.parametrize("n_kv", [1, 2, 6, 32, 64, 256, 1024])
def test_decode_split_schedule(S, n_kv):
    """The split count is a function of the shapes: at least one split,
    chunks of whole 32-row tiles that cover [0, S) with no chunk wholly
    past S, and a grid of about two blocks per SM unless one chunk per
    (b, kv head) already fills the card or the chunks are one tile."""
    n_splits, chunk = _split_schedule(S, n_kv)
    assert n_splits >= 1 and chunk >= TILE_ROWS and chunk % TILE_ROWS == 0
    assert n_splits * chunk >= S > (n_splits - 1) * chunk
    if S > chunk:   # split: the grid reaches the target
        assert n_splits * n_kv >= TARGET_BLOCKS or chunk == TILE_ROWS
    assert _split_schedule(S, n_kv) == (n_splits, chunk)


def test_decode_split_schedule_at_the_serve_shape():
    """At llama3.2-1b's decode shape the grid goes from 32 blocks (one per
    (b, kv head)) to 8 splits of 64 rows: 256 blocks, about two per SM of
    the H100's 132."""
    B, H, KVH, S, D = SERVE_DECODE
    assert _split_schedule(S, B * KVH) == (8, 64)
    assert 8 * B * KVH >= TARGET_BLOCKS >= 2 * H100_SMS - 2 * 4


def _flash_tc_emulation(q, k, v, *, causal, window, split_p=True, bk=64):
    """The bf16 tensor-core flash kernel's roundings in plain PyTorch: bf16
    q/k/v, fp32 scores (exact bf16 products, fp32 sums) scaled by
    1/sqrt(D) after the product, an online softmax over kv tiles of
    ``bk`` keys, P split into bf16 hi + lo (or, with ``split_p=False``,
    rounded once to bf16) with both products summed in fp32, the output
    rounded once to bf16."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    g = H // KVH
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    m = torch.full((B, H, Sq, 1), NEG_INF)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, D)
    qi = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, bk):
        ki = torch.arange(k0, min(k0 + bk, Skv))[None, :]
        s = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        ok = torch.ones(Sq, ki.shape[1], dtype=torch.bool)
        if causal:
            ok &= qi >= ki
        if window > 0:
            ok &= qi - ki < window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + bk]
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).bfloat16()


@pytest.mark.parametrize("B,H,KVH,Sq,Skv,D,causal,win", [
    (1, 32, 8, 319, 319, 64, True, 0),    # llama3.2-1b prefill
    # the shapes of tests/test_torch_cuda.py::test_flash_attention_matches_twin
    (2, 4, 2, 96, 96, 32, True, 0),
    (1, 4, 1, 64, 64, 16, False, 0),
    (2, 8, 4, 80, 80, 32, True, 24),
    (1, 2, 2, 64, 64, 64, True, 0),
    (1, 32, 8, 300, 300, 64, True, 0),
    (1, 4, 2, 37, 70, 128, False, 9),     # Sq != Skv
    (1, 2, 1, 20, 20, 256, True, 3),
])
def test_flash_tensor_core_numerics_hold_the_bf16_gate(B, H, KVH, Sq, Skv,
                                                       D, causal, win):
    """The bf16 kernel's design, checked without a card: its roundings
    stay within one bf16 rounding step (atol 1e-5, rtol 2^-7) of the fp32
    twin and of the Pallas kernel (interpret mode).  At the serve
    shape one bf16 rounding of P, the usual FA2 choice, breaks that
    gate: the split of P into hi + lo is what holds it."""
    arrs = [RNG.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, KVH, Skv, D), (B, KVH, Skv, D))]
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in arrs)
    got = _flash_tc_emulation(tq, tk, tv, causal=causal, window=win)
    twin = attention_ref(tq, tk, tv, causal=causal, window=win)
    torch.testing.assert_close(got.float(), twin.float(), **BF16_GATE)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = j_flash(jq, jk, jv, causal=causal, window=win, block_q=64,
                   block_k=64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_GATE)
    if Sq == 319:
        once = _flash_tc_emulation(tq, tk, tv, causal=causal, window=win,
                                   split_p=False)
        assert not torch.allclose(once.float(), twin.float(), **BF16_GATE)


def _flash_bwd_tc_emulation(q, k, v, o, lse, do, *, causal, window):
    """The bf16 tensor-core backward's roundings in plain PyTorch: bf16 q,
    k, v, o and dO; fp32 S = Q K^T and dP = dO V^T (exact bf16 products,
    fp32 sums), S scaled by 1/sqrt(D) after the product, P = exp(S·scale -
    lse) and dS = P ⊙ (dP - D), D = rowsum(dO ⊙ O), all in fp32; P and dS
    rounded once to bf16 before dV = P^T dO, dK = dS^T Q and dQ = dS K
    (fp32 sums, the GQA group summed in fp32); the outputs rounded once to
    bf16, dq and dk after their scale."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    g = H // KVH
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    qi = torch.arange(Sq)[:, None]
    ki = torch.arange(Skv)[None, :]
    ok = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        ok &= qi >= ki
    if window > 0:
        ok &= qi - ki < window
    s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (dof * o.float()).sum(-1, keepdim=True))
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq = (dsb @ kf) * scale
    dk = ((dsb.transpose(-1, -2) @ qf) * scale).reshape(B, KVH, g, Skv, D)
    dv = (pb.transpose(-1, -2) @ dof).reshape(B, KVH, g, Skv, D)
    return dq.bfloat16(), dk.sum(2).bfloat16(), dv.sum(2).bfloat16()


@pytest.mark.parametrize("B,H,KVH,Sq,Skv,D,causal,win", [
    (8, 32, 8, 256, 256, 64, True, 0),    # llama3.2-1b train shape
    (1, 32, 8, 309, 309, 64, True, 0),    # ... its serve prompt
    (2, 8, 2, 256, 256, 64, True, 64),    # window 64
    (1, 32, 8, 256, 256, 128, True, 0),   # qwen3-4b's head dim
    (2, 8, 2, 130, 130, 40, True, 70),    # D 40, window across kv tiles
])
def test_flash_bwd_tensor_core_numerics_hold_the_bf16_gate(B, H, KVH, Sq,
                                                           Skv, D, causal,
                                                           win):
    """The bf16 backward's design, checked without a card: P and dS
    rounded once to bf16 as tensor-core operands (no hi + lo split) keep
    the gradient within the card's gate, 2e-2 of the call's largest
    gradient element, of ``attention_bwd_ref`` (fp32 arithmetic) on the
    same bf16 inputs, o and lse."""
    arrs = [RNG.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, KVH, Skv, D), (B, KVH, Skv, D),
                      (B, H, Sq, D))]
    tq, tk, tv, tdo = (torch.tensor(a).bfloat16() for a in arrs)
    o, lse = attention_ref(tq, tk, tv, causal=causal, window=win,
                           return_lse=True)
    got = _flash_bwd_tc_emulation(tq, tk, tv, o, lse, tdo, causal=causal,
                                  window=win)
    want = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                             window=win)
    top = max(float(w.float().abs().max()) for w in want)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all()), f"d{name}"
        err = float((a.float() - b.float()).abs().max())
        assert err <= BWD_GATE_BF16 * top, (
            f"d{name}: {err} > {BWD_GATE_BF16} x {top}")


def test_masked_row_convention_follows_the_kernel():
    """A row with no unmasked key gives 0, as the Pallas kernel does (the
    JAX oracle gives the mean of v there); a sequence of length 0 gives 0
    with m = -1e30 and l = 0."""
    q = RNG.standard_normal((1, 2, 16, 8)).astype(np.float32)
    k = RNG.standard_normal((1, 1, 4, 8)).astype(np.float32)
    v = RNG.standard_normal((1, 1, 4, 8)).astype(np.float32)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=False, window=2)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False, window=2, block_q=8, block_k=4)
    _close(got, want, 2e-5)
    assert torch.all(got[:, :, 5:] == 0)             # qi - 3 >= 2: no key
    oracle = np.asarray(j_aref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False, window=2))
    _close(got[:, :, :5], oracle[:, :, :5], 2e-5)
    assert not np.allclose(oracle[:, :, 5:], 0)

    qd = RNG.standard_normal((2, 2, 8)).astype(np.float32)
    kd = RNG.standard_normal((2, 1, 6, 8)).astype(np.float32)
    lens = np.array([0, 3], np.int32)
    o, m, l = decode_attention(torch.tensor(qd), torch.tensor(kd),
                               torch.tensor(kd), torch.tensor(lens),
                               return_stats=True)
    jo, jm, jl = j_decode(jnp.asarray(qd), jnp.asarray(kd), jnp.asarray(kd),
                          jnp.asarray(lens), block_k=2, return_stats=True)
    _close(o, jo, 2e-5)
    assert torch.all(o[0] == 0) and torch.all(l[0] == 0)
    assert torch.all(m[0] == -1e30)
    _close(m, jm, 2e-5)
    _close(l, jl, 2e-5)


def test_wrappers_refuse_other_devices_and_bad_shapes():
    q = torch.zeros(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="device"):
        decode_attention(q[:, :, 0], q[:, :1], q[:, :1],
                         torch.zeros(1, dtype=torch.int32, device="meta"))
