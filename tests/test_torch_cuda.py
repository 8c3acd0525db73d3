"""The port's CUDA kernels on the card, held against their plain twins.

Every test here needs an NVIDIA GPU and skips without one; run them on
the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  The file imports neither ``jax`` nor
``repro``, so it runs where only PyTorch is installed.  The store is
integer, so its kernels must equal their twins exactly.  The attention
kernels and their twins both compute in fp32 and round the result to the
inputs' dtype: they agree within 2e-5 in fp32 (summation order) and
within one rounding step in bf16 (atol 1e-5, rtol 2^-7).  The attention
backward is held to 1e-4 (fp32) and 2e-2 (bf16) of the call's largest
gradient element, the forward's logsumexp to 1e-5 (fp32) and 1e-4 (bf16: the
kernel's base-2 exponentials), and one train step on the card to the
same step on the CPU.
"""

import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch.core import backend as TB
from repro_torch.core import index as TI
from repro_torch.core import store as TS
from repro_torch.core.ref import KEY_MAX, KEY_MIN, TOMBSTONE
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.decode_attention import (
    _split_schedule, decode_attention,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_ref,
)
from repro_torch.kernels.uruv_range.ref import range_scan_ref
from repro_torch.kernels.uruv_range.uruv_range import range_scan
from repro_torch.kernels.uruv_search.ref import (
    index_descend_ref, leaf_slots_at_ref, leaf_slots_ref, search_positions_ref,
)
from repro_torch.kernels.uruv_search.uruv_search import (
    index_descend, leaf_slots, leaf_slots_at, search_positions,
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


def _unaligned(a, dev):
    """``a`` as int32 on ``dev``, contiguous but 4 bytes past a 16-byte
    boundary (a view at an offset)."""
    a = np.asarray(a, np.int32)
    buf = torch.empty(a.size + 1, dtype=torch.int32, device=dev)
    view = buf[1:].view(a.shape)
    view.copy_(torch.as_tensor(a))
    assert view.data_ptr() % 16 == 4
    return view


def _random_levels(rng, F, depth, dev, *, unaligned=False):
    """Random index levels, level 0 the bottom, caps 4^(depth-1-l): sorted
    rows with KEY_MAX padding, child ids past both ends of the level below
    (the kernels clamp them as the JAX gathers do)."""
    caps = [4 ** (depth - 1 - l) for l in range(depth)]
    keys, child = [], []
    for l, cap in enumerate(caps):
        k = np.sort(rng.integers(-1000, 1000, (cap, F)), axis=1)
        k[rng.random((cap, F)) < 0.25] = KEY_MAX
        k = np.sort(k, axis=1).astype(np.int32)
        below = caps[l - 1] if l > 0 else 5000
        c = rng.integers(-below - 2, below + 3, (cap, F)).astype(np.int32)
        make = (lambda a: _unaligned(a, dev)) if unaligned else (
            lambda a: _t(a, dev))
        keys.append(make(k))
        child.append(make(c))
    return keys, child


def _queries(rng, P, dev):
    q = rng.integers(-1100, 1100, P).astype(np.int32)
    q[: min(3, P)] = [KEY_MAX - 1, KEY_MAX, KEY_MIN][: min(3, P)]
    return _t(q, dev)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("F", [4, 6, 8, 16])
def test_index_descend_matches_twin(card, F, depth):
    """Both variants (16-byte loads at F = 4, 8, 16; 4-byte at F = 6) at
    every depth, ragged and whole P: bit for bit against the twin, one
    launch per call."""
    rng = np.random.default_rng(F * 10 + depth)
    keys, child = _random_levels(rng, F, depth, card)
    P = (1, 4095, 4096, 4099)[depth % 4]
    q = _queries(rng, P, card)
    n0 = _build.launch_counts["index_descend"]
    got = index_descend(keys, child, q)
    torch.cuda.synchronize()
    assert _build.launch_counts["index_descend"] == n0 + 1
    _eq(got, index_descend_ref(keys, child, q))


@pytest.mark.parametrize("F,P", [(16, 4099), (8, 1), (4, 4096), (6, 777)])
def test_index_descend_unaligned_levels(card, F, P):
    """Levels that are views 4 bytes past a 16-byte boundary take the
    4-byte variant: the same answers."""
    rng = np.random.default_rng(F + P)
    keys, child = _random_levels(rng, F, 4, card, unaligned=True)
    q = _queries(rng, P, card)
    _eq(index_descend(keys, child, q), index_descend_ref(keys, child, q))


def _rows_case(rng, P, L):
    rows = np.sort(rng.integers(0, 5000, (P, L)), axis=1)
    rows[rng.random((P, L)) < 0.1] = KEY_MAX
    rows = np.sort(rows, axis=1).astype(np.int32)
    q = rng.integers(0, 5100, P).astype(np.int32)
    hit = rng.random(P) < 0.5
    q[hit] = rows[hit, rng.integers(0, L, P)[hit]]
    q[: min(2, P)] = [KEY_MAX - 1, KEY_MAX][: min(2, P)]
    return rows, q


@pytest.mark.parametrize("L,P", [
    (1, 4099), (8, 4096), (33, 4095), (40, 1), (64, 4096), (64, 4099),
    (128, 300), (200, 777),
])
def test_leaf_slots_matches_twin(card, L, P):
    """Gathered rows: one chunk per lane (L = 8, 40, 64, 128) and several
    (L = 33 scalar, 200), ragged P; and the same rows 4 bytes off a
    16-byte boundary."""
    rng = np.random.default_rng(L * 7 + P)
    rows, q = _rows_case(rng, P, L)
    qt = _t(q, card)
    for r in (_t(rows, card), _unaligned(rows, card)):
        n0 = _build.launch_counts["leaf_slots"]
        got = leaf_slots(r, qt)
        torch.cuda.synchronize()
        assert _build.launch_counts["leaf_slots"] == n0 + 1
        _eq(got, leaf_slots_ref(r, qt))


@pytest.mark.parametrize("L,P", [
    (8, 4099), (40, 4095), (64, 4096), (64, 1), (128, 777), (33, 500),
    (200, 300),
])
def test_leaf_slots_at_matches_twin(card, L, P):
    """In place on a pool: ids -1 and past both ends, hits and misses,
    KEY_MAX - 1 and KEY_MAX; aligned and unaligned pools; a snapshot per
    query over chains that cycle; one launch, counted under
    leaf_slots_read."""
    rng = np.random.default_rng(L * 13 + P)
    ML = 300
    pool, _ = _rows_case(rng, ML, L)
    vh = rng.integers(-1, 10**6, (ML, L)).astype(np.int32)
    ids = rng.integers(-ML - 2, ML + 2, P).astype(np.int32)
    ids[::5] = -1
    rows = pool[np.clip(np.where(ids < 0, ids + ML, ids), 0, ML - 1)]
    q = rng.integers(0, 5100, P).astype(np.int32)
    hit = rng.random(P) < 0.6
    q[hit] = rows[hit, rng.integers(0, L, P)[hit]]
    q[: min(2, P)] = [KEY_MAX - 1, KEY_MAX][: min(2, P)]
    it, qt = _t(ids, card), _t(q, card)
    pools = _chains(rng, 1 << 20, card)
    snap = _t(rng.integers(0, 60, P), card)
    for lk, lv in ((_t(pool, card), _t(vh, card)),
                   (_unaligned(pool, card), _unaligned(vh, card))):
        n0 = _build.launch_counts["leaf_slots_read"]
        got = leaf_slots_at(lk, lv, it, qt, snap, *pools, max_chain=64)
        torch.cuda.synchronize()
        assert _build.launch_counts["leaf_slots_read"] == n0 + 1
        _eq(got, leaf_slots_at_ref(lk, lv, it, qt, snap, *pools,
                                   max_chain=64))


def _chains(rng, MV, dev):
    """Version pools [MV] whose chains cycle: random next links, and
    entries 0-4 self-loops newer than every snapshot (a walk through them
    runs its full max_chain steps); tombstones among the values."""
    ts = rng.integers(0, 50, MV)
    nxt = rng.integers(-1, MV, MV)
    ts[:5], nxt[:5] = 1000, np.arange(5)
    val = rng.integers(-2, 99, MV)
    val[::11] = TOMBSTONE
    return tuple(_t(a, dev) for a in (ts, nxt, val))


def _snaps(rng, P, dev):
    """A [P] snapshot, and the scalar and the ``expand``-ed forms of one
    snapshot for all."""
    one = _t(37, dev)
    return (_t(rng.integers(-3, 53, P), dev), one, one.expand(P))


@pytest.mark.parametrize("max_chain", [0, 1, 64])
@pytest.mark.parametrize("MV,P", [(128, 4099), (100_000, 4096), (1024, 1)])
def test_versioned_read_matches_twin(card, MV, P, max_chain):
    """Chains that cycle, heads -1 and into the self-loops, max_chain 0,
    1 and 64, ragged P; the snapshot per query, as a scalar and as an
    expanded scalar (stride 0): bit for bit, one launch a call."""
    rng = np.random.default_rng(MV + P + max_chain)
    pools = _chains(rng, MV, card)
    vh = rng.integers(-1, MV, P)
    vh[::7] = rng.integers(0, 5, len(vh[::7]))
    vh = _t(vh, card)
    for snap in _snaps(rng, P, card):
        n0 = _build.launch_counts["versioned_read"]
        got = versioned_read(vh, snap, *pools, max_chain=max_chain)
        torch.cuda.synchronize()
        assert _build.launch_counts["versioned_read"] == n0 + 1
        _eq(got, versioned_read_ref(vh, snap, *pools, max_chain=max_chain))


@pytest.mark.parametrize("max_chain", [1, 64])
@pytest.mark.parametrize("L,P", [
    (8, 4099), (16, 4096), (64, 4096), (64, 1), (33, 500), (200, 300),
])
def test_leaf_slots_at_with_snapshot_matches_twin(card, L, P, max_chain):
    """The fused rank-and-read: 16-byte rows (L = 8, 16, 64, 200) and
    4-byte ones (L = 33, and every pool 4 bytes off a 16-byte boundary),
    cyclic chains, max_chain 1 and 64, the snapshot per query and one for
    all; bit for bit against the twin (rank, then versioned_read), one
    launch counted under leaf_slots_read and nothing else."""
    rng = np.random.default_rng(L * 17 + P + max_chain)
    ML, MV = 300, 5000
    pool, _ = _rows_case(rng, ML, L)
    vh = rng.integers(-1, MV, (ML, L)).astype(np.int32)
    vh[:, ::9] = rng.integers(0, 5, vh[:, ::9].shape)   # into self-loops
    ids = rng.integers(-ML - 2, ML + 2, P).astype(np.int32)
    rows = pool[np.clip(np.where(ids < 0, ids + ML, ids), 0, ML - 1)]
    q = rng.integers(0, 5100, P).astype(np.int32)
    hit = rng.random(P) < 0.6
    q[hit] = rows[hit, rng.integers(0, L, P)[hit]]
    q[: min(2, P)] = [KEY_MAX - 1, KEY_MAX][: min(2, P)]
    it, qt = _t(ids, card), _t(q, card)
    pools = _chains(rng, MV, card)
    for lk, lv in ((_t(pool, card), _t(vh, card)),
                   (_unaligned(pool, card), _unaligned(vh, card))):
        for snap in _snaps(rng, P, card):
            _build.launch_counts.clear()
            got = leaf_slots_at(lk, lv, it, qt, snap, *pools,
                                max_chain=max_chain)
            torch.cuda.synchronize()
            assert dict(_build.launch_counts) == {"leaf_slots_read": 1}
            _eq(got, leaf_slots_at_ref(lk, lv, it, qt, snap, *pools,
                                       max_chain=max_chain))


@pytest.mark.parametrize("max_chain", [1, 64])
@pytest.mark.parametrize("L,Q,S,valid", [
    (64, 32768, 1, "ragged"),     # the main path's worklist shape
    (64, 4096, 1, "none"),        # every row padding
    (8, 777, 3, "ragged"),
    (16, 300, 2, "random"),
    (33, 257, 3, "random"),       # L % 4 != 0: the 4-byte variant
    (200, 100, 2, "random"),      # more chunks than lanes
])
def test_range_scan_matches_twin(card, L, Q, S, valid, max_chain):
    """The row kernel: all-invalid and ragged worklists (valid rows first,
    as ``bulk_range`` lays them out), random pvalid, L = 8, 16, 33, 64,
    200, inverted intervals, cyclic chains, max_chain 1 and 64, and the
    leaf pools 4 bytes off a 16-byte boundary: bit for bit, one launch a
    call."""
    rng = np.random.default_rng(L * 101 + Q + S + max_chain)
    ML, MV = 2048, 50_000
    lkeys = np.sort(rng.integers(0, 10_000, (ML, L)), axis=1)
    lvh = rng.integers(-1, MV, (ML, L))
    lvh[:, ::9] = rng.integers(0, 5, lvh[:, ::9].shape)
    lcnt = rng.integers(0, L + 1, ML)
    if valid == "random":
        pvalid = rng.random((Q, S)) < 0.8
    else:
        n_ok = 0 if valid == "none" else Q * S // 7 + 3
        pvalid = (np.arange(Q * S) < n_ok).reshape(Q, S)
    lids = np.where(pvalid, rng.integers(-ML - 2, ML + 2, (Q, S)), 0)
    k1 = rng.integers(0, 10_000, Q)
    k2 = k1 + rng.integers(-500, 3000, Q)
    head = (_t(lids, card), _t(pvalid, card, torch.bool), _t(k1, card),
            _t(k2, card), _t(rng.integers(0, 60, Q), card))
    pools = _chains(rng, MV, card)
    for put in (_t, _unaligned):
        leaves = (put(lkeys, card), put(lvh, card), _t(lcnt, card))
        n0 = _build.launch_counts["range_scan"]
        got = range_scan(*head, *leaves, *pools, max_chain=max_chain)
        torch.cuda.synchronize()
        assert _build.launch_counts["range_scan"] == n0 + 1
        want = range_scan_ref(*head, *leaves, *pools, max_chain=max_chain)
        _eq(got, want)
        if valid == "none":
            assert bool((got[0] == KEY_MAX).all())


def test_locate_is_two_launches(card):
    """One ``backend.locate`` on the card, a lookup, launches exactly one
    index_descend and one leaf_slots_read (the rank in place, with the
    chain walked in its launch) and nothing else of the port's, no
    versioned_read, and equals ``locate`` on the CPU: at a snapshot per
    query, one for all, and a strided view of per-query snapshots."""
    rng = np.random.default_rng(2)
    ML, L, n_sep = 2048, 64, 1500
    seps = np.sort(rng.choice(10**7, n_sep, replace=False)).astype(np.int32)
    seps[0] = KEY_MIN
    pad_k = np.full(ML, KEY_MAX, np.int32)
    pad_k[:n_sep] = seps
    pad_l = np.full(ML, -1, np.int32)
    pad_l[:n_sep] = rng.permutation(ML)[:n_sep]
    lk = np.sort(rng.integers(0, 10**7, (ML, L)), axis=1).astype(np.int32)
    lvh = rng.integers(-1, 10**6, (ML, L)).astype(np.int32)
    q = rng.integers(-10, 10**7, 4096).astype(np.int32)
    q[:100] = lk[rng.integers(0, ML, 100), 5]
    snaps = rng.integers(0, 60, 2 * 4096)
    out = {}
    for dev in ("cpu", card):
        idx = TI.build(TI.index_config(ML, 16), ML, _t(pad_k, dev),
                       _t(pad_l, dev), n_sep)
        args = (_t(lk, dev), _t(lvh, dev), _t(q, dev))
        pools = _chains(np.random.default_rng(3), 1 << 16, dev)
        forms = (_t(snaps[:4096], dev), _t(40, dev), _t(snaps, dev)[::2])
        for n, snap in enumerate(forms):
            torch.cuda.synchronize()
            _build.launch_counts.clear()
            got = TB.locate(idx, *args, snap, pools, max_chain=64)
            torch.cuda.synchronize()
            counts = dict(_build.launch_counts)
            assert counts == ({} if dev == "cpu" else
                              {"index_descend": 1, "leaf_slots_read": 1})
            out[f"{dev}-{n}"] = got
    for n in range(3):
        _eq(out[f"cuda-{n}"], out[f"cpu-{n}"])
        _eq(out[f"cuda-{n}"][:6], out["cuda-1"][:6])


def test_stream_ptr_is_the_current_stream(card):
    """The wrappers read the current stream through torch's raw getter;
    it must name the same stream as the public API, on the default
    stream and inside a ``torch.cuda.stream`` context, or every launch
    would go to the wrong stream."""
    q = _t(np.arange(8, dtype=np.int32), card)
    want = torch.cuda.current_stream(q.device).cuda_stream
    assert _build.stream_ptr(q) == want
    side = torch.cuda.Stream(device=q.device)
    with torch.cuda.stream(side):
        assert _build.stream_ptr(q) == side.cuda_stream
        assert _build.stream_ptr(q) == (
            torch.cuda.current_stream(q.device).cuda_stream)
        got = search_positions(_t([0, 3, 5], card), q)
    side.synchronize()
    _eq(got, search_positions_ref(_t([0, 3, 5], card), q))
    assert _build.stream_ptr(q) == want


@pytest.mark.parametrize("n_dir,n_q", [
    (64, 16), (1000, 333), (4096, 256), (7, 5), (1, 40),
    (1 << 17, 4096),                         # the main store's max_leaves
    # the staged design's edges: no directory, K - 1, K and K + 1 of the
    # K = 1024 splitters (the whole directory staged up to K), a multiple
    # and a non-multiple of the stride (S = 256 at both), K = 513 past
    # 131,072, S = 512 at K = 1024 and S = 1024 (two passes a window);
    # P of 1, 31 and not a multiple of the block's 32 queries
    (0, 64), (1023, 500), (1024, 500), (1025, 500), (38_400, 700),
    (38_401, 700), ((1 << 17) + 5, 4096), (1 << 19, 2000),
    ((1 << 19) + 1, 2000), (1 << 17, 1), (22_430, 31), (1 << 17, 1000),
])
def test_search_positions_matches_twin(card, n_dir, n_q):
    """The flat-directory rank kernel at the sweep shapes, at ML =
    131,072 and at the edges of its design, against its twin and
    ``torch.searchsorted``: exact, one counted launch.  Directories past
    40,000 entries are padded with KEY_MAX as the TPU wrapper pads; the
    queries hit every splitter (dir[128 k]) and the key just below it,
    and KEY_MIN, KEY_MAX - 2, KEY_MAX - 1 and KEY_MAX."""
    rng = np.random.default_rng(n_dir + n_q)
    n_real = min(n_dir, 40_000)
    d = np.full(n_dir, KEY_MAX, np.int32)
    d[:n_real] = np.sort(rng.choice(10**7, n_real, replace=False))
    d[:1] = KEY_MIN
    sp = d[::128].astype(np.int64)
    edges = np.concatenate([[KEY_MIN, KEY_MAX - 2, KEY_MAX - 1, KEY_MAX],
                            d[:4], sp, sp - 1]).clip(KEY_MIN, KEY_MAX)
    q = rng.integers(-10, 10**7 + 10, n_q).astype(np.int32)
    q[: min(len(edges), n_q)] = edges[:n_q]
    dk, qk = _t(d, card), _t(q, card)
    n0 = _build.launch_counts["search_positions"]
    got = search_positions(dk, qk)
    torch.cuda.synchronize()
    assert _build.launch_counts["search_positions"] == n0 + 1
    _eq(got, search_positions_ref(dk, qk))
    lib = (torch.searchsorted(dk, qk, right=True).int() - 1).clamp_min(0)
    _eq(got, lib)


def _dup_directory(rng, n_real, n_pad):
    """A sorted directory of ``n_real`` keys drawn from n_real / 8 values
    (runs of equal keys), then ``n_pad`` KEY_MAX."""
    d = np.sort(rng.integers(-10**6, max(n_real // 8, 1), n_real))
    return np.concatenate([d, np.full(n_pad, KEY_MAX)]).astype(np.int32)


def _dup_queries(rng, d):
    sp = d[::128].astype(np.int64)
    q = np.concatenate([rng.integers(-10**6 - 5, d.max(initial=0) // 2 + 5,
                                     3000),
                        d[:2048], sp, sp - 1,
                        [KEY_MIN, KEY_MAX - 2, KEY_MAX - 1, KEY_MAX]])
    return q.clip(KEY_MIN, KEY_MAX).astype(np.int32)


@pytest.mark.parametrize("n_real,n_pad", [
    (1000, 24), (1025, 0), (38_400, 0), (22_430, (1 << 17) - 22_430),
    (5, 1 << 17), ((1 << 17) + 5, 0), ((1 << 19) + 1, 0),
])
def test_search_positions_duplicate_runs(card, n_real, n_pad):
    """Runs of equal keys, inside a window, across window boundaries and
    as long KEY_MAX padding: the rank counts every copy <= q, exactly as
    the twin and ``torch.searchsorted(right=True)`` do; one launch."""
    rng = np.random.default_rng(n_real * 3 + n_pad)
    d = _dup_directory(rng, n_real, n_pad)
    dk, qk = _t(d, card), _t(_dup_queries(rng, d), card)
    n0 = _build.launch_counts["search_positions"]
    got = search_positions(dk, qk)
    torch.cuda.synchronize()
    assert _build.launch_counts["search_positions"] == n0 + 1
    _eq(got, search_positions_ref(dk, qk))
    _eq(got, (torch.searchsorted(dk, qk, right=True).int() - 1).clamp_min(0))


@pytest.mark.parametrize("n_real,n_pad", [
    (1023, 0), (38_401, 0), (22_430, (1 << 17) - 22_430),
])
def test_search_positions_unaligned_directory(card, n_real, n_pad):
    """A directory view 4 bytes off a 16-byte boundary takes the 4-byte
    variant (``_build.vec_for`` gives 1): the same answers as the aligned
    copy, the twin and ``torch.searchsorted``; one launch each."""
    rng = np.random.default_rng(n_real + 7)
    d = _dup_directory(rng, n_real, n_pad)
    qk = _t(_dup_queries(rng, d), card)
    buf = torch.zeros(len(d) + 1, dtype=torch.int32, device=card)
    buf[1:] = _t(d, card)
    view = buf[1:]
    assert view.data_ptr() % 16 == 4
    assert _build.vec_for(4, view.data_ptr()) == 1
    n0 = _build.launch_counts["search_positions"]
    got = search_positions(view, qk)
    aligned = search_positions(_t(d, card), qk)
    torch.cuda.synchronize()
    assert _build.launch_counts["search_positions"] == n0 + 2
    _eq(got, aligned)
    _eq(got, search_positions_ref(view, qk))
    _eq(got, (torch.searchsorted(view, qk, right=True).int() - 1)
        .clamp_min(0))


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
        page = db.scan_page(100, 900, ts, max_scan_leaves=32)
        res += [page.items(), bool(page.truncated[0])]
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
    # lookups and apply passes read through the fused entry; the
    # standalone versioned_read serves scan_page
    assert all(launched.get(k, 0) > 0 for k in
               ("index_descend", "leaf_slots_read", "versioned_read",
                "range_scan"))
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


def _drive_sharded(dev):
    """Seeded mixed plans through ``Uruv.sharded`` (4 shards on ``dev``),
    past growth and with a routing overflow: results and the stacked
    store."""
    from repro_torch.core.sharded import ShardedConfig
    from repro_torch.launch.mesh import make_host_mesh

    cfg = ShardedConfig(base=T.UruvConfig(leaf_cap=16, max_leaves=4,
                                          max_versions=1 << 12,
                                          tracker_cap=16, max_chain=16,
                                          index_fanout=4), key_hi=4000)
    db = T.Uruv.sharded(cfg, make_host_mesh(4, device=dev))
    rng = np.random.default_rng(23)
    res = []
    for p in range(12):
        r = rng.random(32)
        codes = np.where(r < 0.5, T.OP_INSERT, np.where(
            r < 0.65, T.OP_DELETE, T.OP_SEARCH)).astype(np.int32)
        keys = rng.integers(0, 4000, 32).astype(np.int32)
        if p == 6:                         # every key on shard 0
            keys = keys % 1000
        lo = rng.integers(0, 3800, 4).astype(np.int32)
        out = db.apply(T.OpBatch.concat(
            T.OpBatch(codes, keys, rng.integers(1, 999, 32)
                      .astype(np.int32)),
            T.OpBatch.ranges(lo, lo + 200)))
        res += [out.values, out.timestamps, out.pages()]
    with db.snapshot() as ts:
        res.append(db.lookup(np.arange(0, 4000, 7, dtype=np.int32), ts))
        res.append(db.range_all([0, 1990], [2010, 3999], ts))
    res.append(db.compact())
    res.append(db.stats)
    for v in TS.shard_views(db.store):
        TS.check_invariants(v)
    return res, TS.to_numpy(db.store)


def test_compact_walks_two_to_the_31_chain_slots(card):
    """``compact`` of a store with max_leaves x leaf_cap x max_chain =
    2^31 chain slots (the benchmark's paper-uniform-5m store after one
    leaf grow): every live key keeps its newest value."""
    db = T.Uruv(T.UruvConfig(leaf_cap=64, max_leaves=1 << 19,
                             max_versions=1 << 16, max_chain=64,
                             index_fanout=16), device=card)
    rng = np.random.default_rng(0)
    keys = rng.choice(np.arange(1, 1 << 24, dtype=np.int32), 4096,
                      replace=False)
    expect = {}
    for _ in range(3):
        vals = rng.integers(1, 1 << 20, keys.size).astype(np.int32)
        db.insert(keys, vals)
        expect.update(zip(keys.tolist(), vals.tolist()))
    db.delete(keys[:100])
    for k in keys[:100].tolist():
        del expect[k]
    assert db.compact() == len(expect)
    assert sorted(db.live_items()) == sorted(expect.items())
    TS.check_invariants(db.store)


def test_sharded_client_on_card_equals_cpu(card):
    """The same plans through ``Uruv.sharded`` on the card and on the CPU:
    the same results and counters, bit-equal stacked stores; the store
    kernels launched on the card once per shard pass."""
    _build.launch_counts.clear()
    res_c, store_c = _drive_sharded("cuda")
    launched = dict(_build.launch_counts)
    _build.launch_counts.clear()
    res_p, store_p = _drive_sharded("cpu")
    assert not _build.launch_counts
    assert all(launched.get(k, 0) > 0 for k in
               ("index_descend", "leaf_slots_read", "range_scan"))
    assert res_c[-1]["grows"] > 0 and res_c[-1]["device_passes"] > 0
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


@pytest.mark.parametrize("backend,n", [("gloo", 2), ("nccl", 1)])
def test_group_routed_plan_on_card(card, tmp_path, backend, n):
    """The sharded store one shard a process on the card: 2 gloo ranks
    sharing ``cuda:0``, and a 1-rank NCCL group, each through one routed
    plan and a lookup, equal to the stacked store of as many shards on
    the card (answers, clock, rank r's block = shard r), the store
    kernels launched in the ranks."""
    import _dist_ranks as R
    from repro_torch.core import sharded as TSH
    from repro_torch.launch.mesh import make_host_mesh

    with R.Ranks("card", tmp_path, n=n, backend=backend) as ranks:
        cfg = TSH.ShardedConfig(base=T.UruvConfig(**R.CFG), key_hi=R.KEY_HI)
        mesh = make_host_mesh(n, device=card)
        trace, store = R.routed_script(TSH, cfg, mesh, TSH.create(cfg, mesh))
        outs = ranks.results()
    stacked = TS.to_numpy(store)
    assert trace[1]
    for r, o in enumerate(outs):
        assert len(o["trace"]) == len(trace)
        for a, b in zip(o["trace"], trace):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for name, a in o["block"].items():
            np.testing.assert_array_equal(a, stacked[name][r:r + 1],
                                          err_msg=name)
        assert o["launches"].get("index_descend", 0) > 0
        assert o["launches"].get("leaf_slots_read", 0) > 0


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
    # ragged tensor-core tiles: Sq, Skv not multiples of 64, D = 40 padded
    # to 48 in shared memory, windows spanning kv tiles
    (1, 4, 2, 100, 150, 40, True, 0),
    (2, 8, 2, 130, 130, 40, True, 70),
    (1, 4, 4, 200, 77, 40, False, 100),     # Skv < Sq, window, no causal
    (1, 2, 1, 77, 77, 20, True, 0),         # D % 8 != 0: plain-load staging
    (1, 2, 1, 90, 90, 200, True, 65),       # D > 128: 32-key tiles
    (2, 16, 16, 512, 512, 80, False, 0),    # hubert-xlarge: D 80, no mask
    (1, 16, 16, 300, 300, 128, True, 0),    # olmoe-1b-7b prefill, MHA
    (1, 32, 32, 300, 300, 80, True, 0),     # zamba2-2.7b shared block: D 80
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
    (4, 32, 32, 256, 80),                    # zamba2-2.7b decode: MHA, D 80
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,S,D,lens", [
    # the serve shape, 8 splits of 64 rows: empty in every split, ending
    # mid-chunk, in the last chunk, past S
    (4, 32, 8, 512, 64, (0, 100, 481, 700)),
    (2, 8, 2, 300, 128, (299, 0)),          # 10 splits of one tile
    (1, 32, 8, 96, 64, (64, )),             # ends on a chunk boundary
])
def test_decode_attention_split_kv_edges(card, B, H, KVH, S, D, lens,
                                         dtype):
    """The split-KV kernel and its combine where the lengths fall across
    the splits; out, m and l against the twin; one launch counted per
    call."""
    assert _split_schedule(S, B * KVH)[0] > 1
    g = torch.Generator(device="cpu").manual_seed(S + D + B)
    q = torch.randn(B, H, D, generator=g).to(card, dtype)
    k = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    v = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=card)
    n0 = _build.launch_counts["decode_attention"]
    got, m, l = decode_attention(q, k, v, lens, return_stats=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["decode_attention"] == n0 + 1
    want, wm, wl = decode_attention_ref(q, k, v, lens, return_stats=True)
    empty = (lens == 0).cpu()
    assert torch.all(got.cpu()[empty] == 0)
    assert torch.all(l.cpu()[empty] == 0)
    assert torch.all(m.cpu()[empty] == -1e30)
    _close(got, want, TOL[dtype])
    _close(m, wm, 1e-5)
    _close(l, wl, 1e-4)


WINDOW_LENS = (0, 33, 300, 511, 512, 700)   # empty, ..., full, past S


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("window", [1, 24, 100, 1024])
def test_decode_attention_window_matches_twin(card, window, D, dtype):
    """A sliding window: rows [starts[b], lengths[b]) with starts from
    ``lengths - window``, at a window shorter than the length (starts 9,
    200, 411, 600: not multiples of 32), longer than the cache (1024), of
    1 row, at length 0, and at a length past S (its start past S too at
    window 100: no row left)."""
    B, H, KVH, S = len(WINDOW_LENS), 8, 2, 512
    g = torch.Generator(device="cpu").manual_seed(window + D)
    q = torch.randn(B, H, D, generator=g).to(card, dtype)
    k = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    v = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    lens = torch.tensor(WINDOW_LENS, dtype=torch.int32, device=card)
    starts = (lens - window).clamp_min(0).int()
    n0 = _build.launch_counts["decode_attention"]
    got, m, l = decode_attention(q, k, v, lens, starts=starts,
                                 return_stats=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["decode_attention"] == n0 + 1
    want, wm, wl = decode_attention_ref(q, k, v, lens, starts=starts,
                                        return_stats=True)
    empty = (starts >= lens.clamp(max=S)).cpu()
    assert bool(empty[0]) and torch.all(got.cpu()[empty] == 0)
    assert torch.all(l.cpu()[empty] == 0)
    _close(got, want, TOL[dtype])
    _close(m, wm, 1e-5)
    _close(l, wl, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_window_at_gemma3_shape(card, dtype):
    """gemma3-1b's decode: 4 q heads on 1 kv head, D 256, a 2048-row cache,
    lengths 1,209-1,257 and a window of 1024 (starts 185-233), against
    the twin and against the unwindowed kernel on the window's rows."""
    B, H, KVH, S, D, W = 4, 4, 1, 2048, 256, 1024
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn(B, H, D, generator=g).to(card, dtype)
    k = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    v = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    lens = torch.tensor([1209, 1230, 1240, 1257], dtype=torch.int32,
                        device=card)
    starts = (lens - W).int()
    got = decode_attention(q, k, v, lens, starts=starts)
    want = decode_attention_ref(q, k, v, lens, starts=starts)
    _close(got, want, TOL[dtype])
    # the same rows moved to the front of a cache: the unwindowed kernel
    for b in range(B):
        s0 = int(starts[b])
        kb, vb = k[b:b + 1, :, s0:], v[b:b + 1, :, s0:]
        one = decode_attention(q[b:b + 1], kb.contiguous(), vb.contiguous(),
                               torch.tensor([W], dtype=torch.int32,
                                            device=card))
        _close(got[b:b + 1], one, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_window_zero_is_unwindowed(card, dtype):
    """Starts of 0 launch the windowed variant over every row: bit for bit
    the unwindowed kernel's out, m and l (the split schedule and the row
    order are the same)."""
    B, H, KVH, S, D = 4, 32, 8, 512, 64
    g = torch.Generator(device="cpu").manual_seed(11)
    q = torch.randn(B, H, D, generator=g).to(card, dtype)
    k = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    v = torch.randn(B, KVH, S, D, generator=g).to(card, dtype)
    lens = torch.tensor([0, 100, 481, 700], dtype=torch.int32, device=card)
    plain = decode_attention(q, k, v, lens, return_stats=True)
    zero = decode_attention(q, k, v, lens, starts=torch.zeros_like(lens),
                            return_stats=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(plain, zero))


def test_attention_launch_counts(card):
    """Each wrapper call counts one launch, whatever the kernels it runs
    (decode's split kernel and its combine count once)."""
    q = torch.randn(1, 4, 70, 64, device=card, dtype=torch.bfloat16)
    kv = torch.randn(1, 2, 70, 64, device=card, dtype=torch.bfloat16)
    qd = torch.randn(4, 32, 64, device=card, dtype=torch.bfloat16)
    kd = torch.randn(4, 8, 512, 64, device=card, dtype=torch.bfloat16)
    lens = torch.tensor([512, 3, 0, 200], dtype=torch.int32, device=card)
    _build.launch_counts.clear()
    for _ in range(3):
        flash_attention(q, kv, kv)
        decode_attention(qd, kd, kd, lens)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"flash_attention": 3,
                                          "decode_attention": 3}


# ---------------------------------------------------------------------------
# the attention's backward, the forward's logsumexp, and training on the card
# ---------------------------------------------------------------------------

BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # of max |grad|
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
BWD_SHAPES = [                 # B, H, KVH, Sq, Skv, D, causal, window
    (2, 4, 2, 96, 96, 32, True, 0),
    (1, 32, 8, 256, 256, 64, True, 0),      # llama3.2-1b train widths
    (1, 32, 8, 309, 309, 64, True, 0),      # ... and its serve prompt
    (1, 8, 8, 63, 63, 64, True, 64),
    (2, 8, 2, 130, 130, 40, True, 70),      # window across kv tiles
    (1, 4, 2, 37, 70, 128, False, 9),       # Sq != Skv
    (1, 4, 4, 200, 77, 40, False, 100),     # Skv < Sq, no causal
    (1, 2, 1, 20, 20, 256, True, 3),        # widest head dim
    (1, 2, 1, 77, 77, 20, True, 0),         # D % 8 != 0
    (1, 4, 2, 1, 1, 64, True, 0),           # one row
    (1, 32, 8, 256, 256, 128, True, 0),     # D 128 at train width
    (1, 4, 2, 100, 100, 72, True, 0),       # D % 16 != 0: padded cp.async
    (1, 4, 2, 90, 90, 36, True, 20),        # D % 8 != 0: plain loads
    (1, 8, 2, 150, 200, 64, True, 0),       # Sq % 64 != 0, Sq != Skv, causal
    (2, 16, 16, 512, 512, 80, False, 0),    # hubert-xlarge train: D 80
    (1, 16, 16, 130, 130, 80, False, 0),    # ... ragged, D 80 padded
    (1, 32, 32, 256, 256, 80, True, 0),     # zamba2-2.7b: D 80, causal
]


def _rel_close(got, want, tol, what, scale=None):
    """|got - want| <= tol x ``scale`` (default: want's largest |element|)."""
    g, w = got.float().cpu(), want.float().cpu()
    scale = scale or float(w.abs().max()) or 1.0
    err = float((g - w).abs().max())
    assert torch.isfinite(g).all(), what
    assert err <= tol * scale, f"{what}: max abs {err} > {tol} x {scale}"


def _qkv(card, dtype, B, H, KVH, Sq, Skv, D, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=g).to(card, dtype)
            for s in ((B, H, Sq, D), (B, KVH, Skv, D), (B, KVH, Skv, D),
                      (B, H, Sq, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,Sq,Skv,D,causal,win", BWD_SHAPES)
def test_flash_attention_lse_matches_twin(card, B, H, KVH, Sq, Skv, D,
                                          causal, win, dtype):
    q, k, v, _ = _qkv(card, dtype, B, H, KVH, Sq, Skv, D, Sq + D)
    out, lse = flash_attention(q, k, v, causal=causal, window=win,
                               return_lse=True)
    torch.cuda.synchronize()
    want, wlse = attention_ref(q, k, v, causal=causal, window=win,
                               return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    _close(out, want, TOL[dtype])
    np.testing.assert_allclose(lse.cpu().numpy(), wlse.cpu().numpy(),
                               atol=LSE_TOL[dtype], rtol=1e-6)
    # the serve path asks for no lse: the same output
    _close(flash_attention(q, k, v, causal=causal, window=win), out, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,Sq,Skv,D,causal,win", BWD_SHAPES)
def test_flash_attention_bwd_matches_twin(card, B, H, KVH, Sq, Skv, D,
                                          causal, win, dtype):
    q, k, v, do = _qkv(card, dtype, B, H, KVH, Sq, Skv, D, 7 * Sq + D)
    o, lse = flash_attention(q, k, v, causal=causal, window=win,
                             return_lse=True)
    n0 = _build.launch_counts["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=win)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_bwd"] == n0 + 1
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=win)
    # the call's largest gradient element (dq alone may be all but 0: one
    # key gives dS = 0)
    scale = max(float(w.float().abs().max()) for w in want)
    for name, a, b, ref in zip("qkv", got, want, (q, k, v)):
        assert a.dtype == dtype and a.shape == ref.shape
        _rel_close(a, b, BWD_TOL[dtype], f"d{name}", scale)


def test_flash_attention_bwd_is_bit_identical_run_to_run(card):
    """No two blocks write one gradient element (no atomics): two calls at
    the train shape give the same dq, dk and dv, bit for bit."""
    q, k, v, do = _qkv(card, torch.bfloat16, 8, 32, 8, 256, 256, 64, 11)
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    first = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_bwd_masked_rows(card):
    """A row with no unmasked key (a window past the kv length) has lse
    -inf and adds nothing: its dq is 0, and no gradient is NaN."""
    q, k, v, do = _qkv(card, torch.float32, 1, 2, 1, 16, 4, 32, 3)
    o, lse = flash_attention(q, k, v, causal=False, window=2,
                             return_lse=True)
    assert torch.all(torch.isneginf(lse[:, :, 5:]))
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=False,
                                     window=2)
    assert torch.all(dq[:, :, 5:] == 0)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=False, window=2)
    for a, b in zip((dq, dk, dv), want):
        _rel_close(a, b, BWD_TOL[torch.float32], "masked rows")


def _attention_f64(q, k, v, *, causal: bool, window: int):
    """The twin's arithmetic in float64 on the CPU (no -1e30 sentinel:
    every row here sees a key)."""
    q, k, v = (t.detach().cpu().double() for t in (q, k, v))
    group = q.shape[1] // k.shape[1]
    kx, vx = (t.repeat_interleave(group, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q / q.shape[-1] ** 0.5, kx)
    qi = torch.arange(q.shape[2])[:, None]
    ki = torch.arange(k.shape[2])[None, :]
    mask = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= qi - ki < window
    p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx)


def test_attention_autograd_on_card(card):
    """``ops.attention`` under autograd: one forward and one backward
    launch, the output within 2e-5 of float64 arithmetic, the CPU twins'
    gradient; without a gradient it is the forward alone."""
    q, k, v, do = _qkv(card, torch.float32, 2, 8, 2, 70, 70, 64, 5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _build.launch_counts.clear()
    out = attention(*leaves, causal=True, window=24)
    out.backward(do)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"flash_attention": 1,
                                          "flash_attention_bwd": 1}
    # the output against the twin's arithmetic in float64 (the CPU twin's
    # own fp32 output holds float64 in tests/test_torch_attention.py)
    _close(out.detach(), _attention_f64(q, k, v, causal=True, window=24),
           TOL[torch.float32])
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    attention(*cpu, causal=True, window=24).backward(do.cpu())
    for a, b in zip(leaves, cpu):
        _rel_close(a.grad, b.grad, BWD_TOL[torch.float32], "autograd")
    with torch.no_grad():
        assert attention(*leaves).grad_fn is None


def test_train_step_on_card_equals_cpu(card):
    """One AdamW step of reduced llama3.2-1b (fp32) on the card and on
    the CPU from the same weights: loss and grad norm within 1e-5, the
    clipped gradient (``(1 - b1)`` times the first moment) within 1e-4 of
    its largest element, the update within 1e-2 in norm (Adam's first
    step divides each gradient by its own size, so a gradient near 0 may
    move its element's update by up to 2·lr)."""
    from repro_torch.config import get_arch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import steps

    cfg = get_arch("llama3_2_1b").reduced()
    opt = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    step = steps.make_train_step(cfg, opt)
    st0 = steps.init_state(cfg, torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        st = tree_map(lambda t: t.clone().to(dev), st0)
        _build.launch_counts.clear()
        st, met = step(st, make_batch(cfg, 2, 48, 0, device=dev))
        out[dev] = (st, met, dict(_build.launch_counts))
    (sc, mc, _), (sg, mg, counts) = out["cpu"], out["cuda"]
    L = cfg.n_layers
    assert counts == {"flash_attention": 2 * L, "flash_attention_bwd": L}
    for key in ("loss", "grad_norm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * abs(
            float(mc[key]))
    for a, b in zip(tree_leaves(sg.opt.m), tree_leaves(sc.opt.m)):
        _rel_close(a, b, 1e-4, "first moment")
    for pg, pc, p0 in zip(tree_leaves(sg.params), tree_leaves(sc.params),
                          tree_leaves(st0.params)):
        dg, dc = pg.cpu() - p0, pc - p0
        assert float((dg - dc).norm()) <= 1e-2 * float(dc.norm())


# ---------------------------------------------------------------------------
# the MoE layer on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_moe_16b"])
def test_moe_fwd_on_card_equals_cpu(card, arch, monkeypatch):
    """Reduced MoE (fp32): the card routes by the CPU's choices (its gates
    from its own probabilities), so the output and aux values hold within
    1e-5 and the input's and weights' gradients within 1e-4 of their
    largest element whatever the routers choose; the card's own choices
    may differ from the CPU's only where the CPU's top-k margin is below
    1e-5."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.models import moe
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2))
    p0 = moe.init_moe(cfg, torch.Generator().manual_seed(1))
    x0 = torch.randn(3, 40, cfg.d_model,
                     generator=torch.Generator().manual_seed(2))
    route, own, pin = moe.route, {}, []

    def pinned(cfg_, p_, xt):
        logits, probs, gate, choice = route(cfg_, p_, xt)
        own[xt.device.type] = (choice.detach().sort(-1).values.cpu(),
                               probs.detach().cpu())
        if xt.device.type == "cpu":
            pin.append(choice.detach())
            return logits, probs, gate, choice
        choice = pin[0].to(xt.device)
        g = probs.gather(-1, choice)
        return logits, probs, g / g.sum(-1, keepdim=True).clamp_min(1e-9), \
            choice
    monkeypatch.setattr(moe, "route", pinned)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(), p0)
        x = x0.to(dev, copy=True).requires_grad_()
        y, aux = moe.moe_fwd(cfg, p, x)
        grads = torch.autograd.grad((y * y).sum() + aux["moe_balance"],
                                    [x] + tree_leaves(p))
        out[dev] = (y.detach().cpu(),
                    {k: float(v.detach()) for k, v in aux.items()},
                    [g.cpu() for g in grads])
    (yc, ac, gc), (yg, ag, gg) = out["cpu"], out["cuda"]
    _close(yg, yc, 1e-5)
    for k in ac:
        assert abs(ag[k] - ac[k]) <= 1e-5 * max(1.0, abs(ac[k])), k
    for a, b in zip(gg, gc):
        _rel_close(a, b, 1e-4, "moe gradient")
    (cc, pc), (cg, _) = own["cpu"], own["cuda"]
    top = pc.sort(-1, descending=True).values
    margin = top[:, cfg.moe.top_k - 1] - top[:, cfg.moe.top_k]
    differ = (cc != cg).any(-1)
    assert not differ.any() or float(margin[differ].max()) < 1e-5, \
        margin[differ]


def test_moe_combine_is_bit_identical_on_card(card):
    """olmoe's routing widths (64 experts, top-8) in bf16: two forward and
    backward runs give the same output and gradients, bit for bit (every
    token gathers its K slots; no atomic add in either direction)."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_arch("olmoe_1b_7b"), d_model=512,
                              compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, d_expert=256, capacity_factor=1.0))       # drops some
    p = moe.init_moe(cfg, torch.Generator(device="cuda").manual_seed(3))
    x = torch.randn(4, 256, 512, device="cuda").to(torch.bfloat16)
    runs = []
    for _ in range(2):
        xi = x.clone().requires_grad_()
        y, aux = moe.moe_fwd(cfg, p, xi)
        (g,) = torch.autograd.grad(y.float().square().sum(), xi)
        runs.append((y, g, aux["moe_dropped"]))
    torch.cuda.synchronize()
    (y1, g1, d1), (y2, g2, d2) = runs
    assert torch.equal(y1, y2) and torch.equal(g1, g2)
    assert float(d1) == float(d2) and float(d1) > 0


def _ssd_both(card, args, chunk):
    from repro_torch.models import mamba2

    assert not torch.backends.cuda.matmul.allow_tf32
    got = mamba2.ssd_chunked(*(t.to(card) for t in args), chunk)
    want = mamba2.ssd_chunked(*args, chunk)
    torch.cuda.synchronize()
    return got, want


def _ssd_random(B, S, H, P, N, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(B, S, H, P, generator=g),
            torch.rand(B, S, H, generator=g) * 0.5 + 0.5,
            torch.randn(B, S, H, N, generator=g),
            torch.randn(B, S, H, N, generator=g))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 3, 8, 8, 16), (2, 12, 3, 8, 8, 16), (1, 32, 2, 17, 16, 16),
], ids=["chunks", "short", "p_hd_plus_1"])
def test_ssd_chunked_on_card_equals_cpu(card, B, S, H, P, N, chunk):
    """``mamba2.ssd_chunked`` (the Mamba2 and mLSTM scan, PyTorch code on
    the card) on identical inputs on the card and on the CPU, at the CPU
    parity test's shapes: within atol = rtol = 1e-5 (fp32 products of
    bf16-rounded operands; TF32 off, PyTorch's default)."""
    (y, h), (wy, wh) = _ssd_both(card, _ssd_random(B, S, H, P, N, S * H + P),
                                 chunk)
    _close(y, wy, 1e-5)
    _close(h, wh, 1e-5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 80, 64, 64, 256),                # zamba2-2.7b: 80 heads of 64
    (1, 64, 8, 257, 256, 256),               # xlstm-350m: P = hd + 1
], ids=["zamba2", "xlstm"])
def test_ssd_chunked_on_card_at_full_width(card, B, S, H, P, N, chunk):
    """At the families' widths.  With integer operands and no decay every
    intermediate is an exact fp32 integer, the same on both devices
    whatever the summation order: bit-equal.  With random operands the
    scan rounds fp32 values that cuBLAS and the CPU sum in different
    orders to bf16, and a value within an ulp of a rounding boundary
    rounds apart (0.135-0.19 % of the elements measured on the H100):
    all but 0.5 % of the elements within 1e-5, every element within
    1e-2 x max |y|, the chunked-against-recurrent bound of the CPU
    tests."""
    g = torch.Generator(device="cpu").manual_seed(P)
    ints = (torch.randint(-4, 5, (B, S, H, P), generator=g).float(),
            torch.ones(B, S, H),
            torch.randint(-4, 5, (B, S, H, N), generator=g).float(),
            torch.randint(-4, 5, (B, S, H, N), generator=g).float())
    (y, h), (wy, wh) = _ssd_both(card, ints, chunk)
    assert torch.equal(y.cpu(), wy) and torch.equal(h.cpu(), wh)
    (y, h), (wy, wh) = _ssd_both(card, _ssd_random(B, S, H, P, N, S * H + P),
                                 chunk)
    for got, want in ((y.cpu(), wy), (h.cpu(), wh)):
        off = (got - want).abs() > 1e-5 + 1e-5 * want.abs()
        assert float(off.float().mean()) <= 5e-3
        assert float((got - want).abs().max()) <= 1e-2 * float(
            want.abs().max())


def test_dryrun_leaves_the_card_untouched(card):
    """A full-width meta trace of llama3.2-1b's train step: every tensor
    on ``meta``, the card's allocated bytes unchanged."""
    from repro_torch.launch.dryrun import run_cell

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rec = run_cell("llama3_2_1b", "train_4k", "single")
    torch.cuda.synchronize()
    assert rec["status"] == "OK" and rec["device"] == "meta"
    assert torch.cuda.memory_allocated() == before
