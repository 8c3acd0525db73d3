"""The port's CUDA kernels on the card, held against their plain twins.

Every test here needs an NVIDIA GPU and skips without one; run them on
the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  The file imports neither ``jax`` nor
``repro``, so it runs where only PyTorch is installed.  The store is
integer, so its kernels must equal their twins exactly.  The attention
kernels and their twins both compute in fp32 and round the result to the
inputs' dtype: they agree within 2e-5 in fp32 (summation order) and
within one rounding step in bf16 (atol 1e-5, rtol 2^-7).
"""

import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch.core import index as TI
from repro_torch.core import store as TS
from repro_torch.core.ref import KEY_MAX, KEY_MIN, TOMBSTONE
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.uruv_range.ref import range_scan_ref
from repro_torch.kernels.uruv_range.uruv_range import range_scan
from repro_torch.kernels.uruv_search.ref import (
    index_descend_ref, leaf_slots_ref, search_positions_ref,
)
from repro_torch.kernels.uruv_search.uruv_search import (
    index_descend, leaf_slots, search_positions,
)
from repro_torch.kernels.versioned_read.ref import versioned_read_ref
from repro_torch.kernels.versioned_read.versioned_read import versioned_read

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, dev, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), device=dev).to(dtype)


def _eq(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_kernels_match_twins(card):
    rng = np.random.default_rng(11)
    ML, n_sep = 256, 200
    seps = np.sort(rng.choice(10**6, n_sep, replace=False)).astype(np.int32)
    seps[0] = KEY_MIN
    pad_k = np.full(ML, KEY_MAX, np.int32)
    pad_k[:n_sep] = seps
    pad_l = np.full(ML, -1, np.int32)
    pad_l[:n_sep] = rng.permutation(ML)[:n_sep]
    idx = TI.build(TI.index_config(ML, 8), ML, _t(pad_k, card),
                   _t(pad_l, card), n_sep)
    q = _t(np.concatenate([rng.integers(-10, 10**6 + 10, 333), seps,
                           [KEY_MAX - 1, KEY_MAX]]).astype(np.int32), card)
    _eq(index_descend(idx.node_keys, idx.node_child, q),
        index_descend_ref(idx.node_keys, idx.node_child, q))

    rows = _t(np.sort(rng.integers(0, 500, (257, 40)), axis=1), card)
    qs = rng.integers(0, 520, 257).astype(np.int32)
    qs[:3] = KEY_MAX - 1
    qs = _t(qs, card)
    _eq(leaf_slots(rows, qs), leaf_slots_ref(rows, qs))

    MV, P = 1024, 500
    val = rng.integers(0, 99, MV)
    val[::11] = TOMBSTONE
    arrs = [_t(a, card) for a in (
        rng.integers(-1, MV, P), rng.integers(0, 50, P),
        rng.integers(0, 50, MV), rng.integers(-1, MV, MV), val)]
    _eq(versioned_read(*arrs, max_chain=16),
        versioned_read_ref(*arrs, max_chain=16))

    Q, Sw, ML, L = 100, 4, 128, 16
    k1 = rng.integers(0, 1000, Q)
    args = (_t(rng.integers(0, ML, (Q, Sw)), card),
            _t(rng.random((Q, Sw)) < 0.8, card, torch.bool),
            _t(k1, card), _t(k1 + rng.integers(-50, 400, Q), card),
            _t(rng.integers(0, 60, Q), card),
            _t(np.sort(rng.integers(0, 1000, (ML, L)), axis=1), card),
            _t(rng.integers(-1, MV, (ML, L)), card),
            _t(rng.integers(0, L + 1, ML), card),
            _t(rng.integers(0, 60, MV), card),
            _t(rng.integers(-1, MV, MV), card), _t(val, card))
    _eq(range_scan(*args, max_chain=8), range_scan_ref(*args, max_chain=8))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_dir,n_q", [
    (64, 16), (1000, 333), (4096, 256), (7, 5), (1, 40),
    (1 << 17, 4096),                         # the main store's max_leaves
])
def test_search_positions_matches_twin(card, n_dir, n_q):
    """The flat-directory rank kernel at the sweep shapes and at ML =
    131,072, against its twin and ``torch.searchsorted``: exact.  The
    large case pads a sorted directory with KEY_MAX as the TPU wrapper
    does; queries stay in the valid key domain (below KEY_MAX - 1)."""
    rng = np.random.default_rng(n_dir + n_q)
    n_real = min(n_dir, 40_000)
    d = np.full(n_dir, KEY_MAX, np.int32)
    d[:n_real] = np.sort(rng.choice(10**7, n_real, replace=False))
    d[0] = KEY_MIN
    q = rng.integers(-10, 10**7 + 10, n_q).astype(np.int32)
    q[: min(4, n_q)] = d[: min(4, n_q)]
    dk, qk = _t(d, card), _t(q, card)
    n0 = _build.launch_counts["search_positions"]
    got = search_positions(dk, qk)
    torch.cuda.synchronize()
    assert _build.launch_counts["search_positions"] == n0 + 1
    _eq(got, search_positions_ref(dk, qk))
    lib = (torch.searchsorted(dk, qk, right=True).int() - 1).clamp_min(0)
    _eq(got, lib)


def _drive(cfg, dev):
    """Six mixed plans with RANGE ops, a held snapshot, compact and
    reindex; returns (every result, the final store's arrays)."""
    db = T.Uruv(cfg, device=dev)
    rng = np.random.default_rng(5)
    res = []
    for _ in range(6):
        k = rng.integers(0, 2000, 96).astype(np.int32)
        c = rng.choice([T.OP_INSERT, T.OP_DELETE, T.OP_SEARCH], 96,
                       p=[0.6, 0.15, 0.25]).astype(np.int32)
        lo = rng.integers(0, 2000, 4).astype(np.int32)
        r = db.apply(T.OpBatch.concat(
            T.OpBatch(c, k, rng.integers(1, 999, 96).astype(np.int32)),
            T.OpBatch.ranges(lo, lo + 150)))
        res += [r.values, r.timestamps, r.pages()]
    with db.snapshot() as ts:
        res.append(db.range(0, 1999, ts))
        res.append(db.lookup(np.arange(0, 2000, 7, dtype=np.int32), ts))
    res.append(db.compact())
    db.reindex()
    TS.check_invariants(db.store)
    return res, TS.to_numpy(db.store)


def test_client_on_card_equals_cpu(card):
    """The same plans through ``Uruv`` on the card and on the CPU: the same
    results and a bit-equal store; every kernel launched on the card."""
    cfg = T.UruvConfig(leaf_cap=8, max_leaves=512, max_versions=1 << 13,
                       tracker_cap=16, max_chain=16, index_fanout=4)
    _build.launch_counts.clear()
    res_c, store_c = _drive(cfg, "cuda")
    launched = dict(_build.launch_counts)
    _build.launch_counts.clear()
    res_p, store_p = _drive(cfg, "cpu")
    assert not _build.launch_counts
    assert all(launched.get(k, 0) > 0 for k in
               ("index_descend", "leaf_slots", "versioned_read", "range_scan"))
    assert len(res_c) == len(res_p)
    for a, b in zip(res_c, res_p):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert sorted(store_c) == sorted(store_p)
    for name in store_c:
        assert store_c[name].dtype == store_p[name].dtype, name
        np.testing.assert_array_equal(store_c[name], store_p[name],
                                      err_msg=name)


TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}


def _close(got, want, tol):
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,Sq,Skv,D,causal,win", [
    (2, 4, 2, 96, 96, 32, True, 0),
    (1, 4, 1, 64, 64, 16, False, 0),
    (2, 8, 4, 80, 80, 32, True, 24),
    (1, 2, 2, 64, 64, 64, True, 0),
    (1, 32, 8, 300, 300, 64, True, 0),      # llama3.2-1b prefill widths
    (1, 4, 2, 37, 70, 128, False, 9),       # ragged, Sq != Skv
    (1, 2, 1, 20, 20, 256, True, 3),        # widest head, >48 KB smem
])
def test_flash_attention_matches_twin(card, B, H, KVH, Sq, Skv, D, causal,
                                      win, dtype):
    g = torch.Generator(device="cpu").manual_seed(B * 1000 + Sq + D)
    q, k, v = (torch.randn(shape, generator=g).to(card, dtype)
               for shape in ((B, H, Sq, D), (B, KVH, Skv, D),
                             (B, KVH, Skv, D)))
    n0 = _build.launch_counts["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention"] == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, attention_ref(q, k, v, causal=causal, window=win),
           TOL[dtype])


def test_flash_attention_masked_rows_give_zero(card):
    """Rows with no unmasked key (a window past the kv length) output 0."""
    q = torch.randn(1, 2, 16, 32, device=card)
    k = torch.randn(1, 1, 4, 32, device=card)
    v = torch.randn(1, 1, 4, 32, device=card)
    got = flash_attention(q, k, v, causal=False, window=2)
    want = attention_ref(q, k, v, causal=False, window=2)
    assert torch.all(got[:, :, 6:] == 0)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,S,D", [
    (3, 8, 2, 100, 32), (2, 4, 4, 64, 16), (1, 8, 1, 130, 64),
    (4, 32, 8, 512, 64),                     # llama3.2-1b decode widths
    (2, 32, 8, 77, 128), (2, 2, 2, 40, 256),
])
def test_decode_attention_matches_twin(card, B, H, KVH, S, D, dtype):
    g = torch.Generator(device="cpu").manual_seed(B * 100 + S + D)
    q = torch.randn(B, H, D, generator=g).to(card, dtype)
    k = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    v = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    lens = torch.randint(0, S + 3, (B,), generator=g).int().to(card)
    lens[0] = 0                              # an empty sequence gives 0
    got, m, l = decode_attention(q, k, v, lens, return_stats=True)
    want, wm, wl = decode_attention_ref(q, k, v, lens, return_stats=True)
    torch.cuda.synchronize()
    assert torch.all(got[0] == 0) and torch.all(l[0] == 0)
    _close(got, want, TOL[dtype])
    _close(m, wm, 1e-5)
    _close(l, wl, 1e-4)
