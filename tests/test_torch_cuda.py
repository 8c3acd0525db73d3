"""The port's CUDA kernels on the card, held against their plain twins.

Every test here needs an NVIDIA GPU and skips without one; run them on
the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  The file imports neither ``jax`` nor
``repro``, so it runs where only PyTorch is installed.  The store is
integer, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch.core import index as TI
from repro_torch.core import store as TS
from repro_torch.core.ref import KEY_MAX, KEY_MIN, TOMBSTONE
from repro_torch.kernels import _build
from repro_torch.kernels.uruv_range.ref import range_scan_ref
from repro_torch.kernels.uruv_range.uruv_range import range_scan
from repro_torch.kernels.uruv_search.ref import (
    index_descend_ref, leaf_slots_ref,
)
from repro_torch.kernels.uruv_search.uruv_search import (
    index_descend, leaf_slots,
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
