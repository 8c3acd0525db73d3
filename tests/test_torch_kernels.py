"""The port's kernel twins against the JAX package's, on the CPU.

Every kernel wrapper of ``repro_torch.kernels`` takes its plain PyTorch
twin for a CPU tensor; these sweeps feed it the inputs of
``tests/test_kernels.py`` (made with numpy from a seed) and require the
JAX oracle's answer bit for bit — the store is integer, so the tolerance
is exact equality.  One shape per kernel is also held against the JAX
Pallas kernel in interpret mode.  The CUDA kernels themselves run only on
a card: ``tests/test_torch_cuda.py`` holds them against the same twins
there.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import backend as JB
from repro.core import index as JI
from repro.core.ref import KEY_MAX
from repro.kernels.uruv_range.ref import range_scan_ref as j_range_scan_ref
from repro.kernels.uruv_range.uruv_range import range_scan as j_range_scan
from repro.kernels.uruv_search.ref import (
    index_descend_ref as j_index_descend_ref, leaf_slots_ref as j_leaf_slots_ref,
    search_positions_ref as j_search_positions_ref,
)
from repro.kernels.uruv_search.uruv_search import (
    index_descend as j_index_descend, leaf_slots as j_leaf_slots,
    search_positions as j_search_positions,
)
from repro.kernels.versioned_read.ref import (
    versioned_read_ref as j_versioned_read_ref,
)
from repro.kernels.versioned_read.versioned_read import (
    versioned_read as j_versioned_read,
)

from repro_torch.core import backend as TB
from repro_torch.core import index as TI
from repro_torch.kernels import _build
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

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    bounded_jax_maps, fresh_jax_caches,
)

TOMB = -(2**31) + 1


def _t(a, dtype=torch.int32, device="cpu"):
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _eq(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


def _index_case(rng, fanout, n_sep, n_q):
    ML = 256
    seps = np.sort(rng.choice(10**6, n_sep, replace=False)).astype(np.int32)
    seps[0] = JI.KEY_MIN
    pad_k = np.full(ML, KEY_MAX, np.int32)
    pad_k[:n_sep] = seps
    pad_l = np.full(ML, -1, np.int32)
    pad_l[:n_sep] = np.arange(n_sep, dtype=np.int32)
    q = np.concatenate([
        rng.integers(-10, 10**6 + 10, n_q).astype(np.int32),
        seps[:8], seps[:8] + 1, np.array([KEY_MAX - 1], np.int32),
    ])
    jidx = JI.build(JI.index_config(ML, fanout), ML, pad_k, pad_l,
                    jnp.asarray(n_sep, jnp.int32))
    tidx = TI.build(TI.index_config(ML, fanout), ML, _t(pad_k), _t(pad_l),
                    n_sep)
    return jidx, tidx, q


def _range_case(rng, Q, Sw, ML, L, MV):
    lkeys = np.sort(rng.integers(0, 1000, (ML, L)), axis=1).astype(np.int32)
    lvh = rng.integers(-1, MV, (ML, L)).astype(np.int32)
    lcnt = rng.integers(0, L + 1, ML).astype(np.int32)
    vts = rng.integers(0, 60, MV).astype(np.int32)
    vnxt = rng.integers(-1, MV, MV).astype(np.int32)
    vval = rng.integers(-2, 99, MV).astype(np.int32)
    vval[::13] = TOMB
    lids = rng.integers(0, ML, (Q, Sw)).astype(np.int32)
    pvalid = rng.random((Q, Sw)) < 0.8
    k1 = rng.integers(0, 1000, Q).astype(np.int32)
    k2 = (k1 + rng.integers(-50, 400, Q)).astype(np.int32)  # some inverted
    snap = rng.integers(0, 60, Q).astype(np.int32)
    return (lids, pvalid, k1, k2, snap, lkeys, lvh, lcnt, vts, vnxt, vval)


def _torch_args(args):
    return tuple(_t(a, torch.bool if a.dtype == np.bool_ else torch.int32)
                 for a in args)


@pytest.mark.parametrize("fanout,n_sep,n_q", [
    (4, 40, 64), (8, 200, 333), (16, 250, 64),
])
def test_index_descend_twin_matches_jax(fanout, n_sep, n_q):
    rng = np.random.default_rng(fanout * 1000 + n_sep)
    jidx, tidx, q = _index_case(rng, fanout, n_sep, n_q)
    want = j_index_descend_ref(jidx.node_keys, jidx.node_child, jnp.asarray(q))
    _eq(index_descend(tidx.node_keys, tidx.node_child, _t(q)), want)
    _eq(index_descend_ref(tidx.node_keys, tidx.node_child, _t(q)), want)
    # the index module's descent (with its path) agrees too
    _eq(TI.descend(tidx, _t(q)), JI.descend(jidx, jnp.asarray(q)))
    _eq(TI.descend_path(tidx, _t(q)), JI.descend_path(jidx, jnp.asarray(q)))


@pytest.mark.parametrize("P,L", [(16, 8), (100, 32), (257, 16)])
def test_leaf_slots_twin_matches_jax(P, L):
    rng = np.random.default_rng(P * 100 + L)
    rows = np.sort(rng.integers(0, 500, (P, L)), axis=1).astype(np.int32)
    q = rng.integers(0, 520, P).astype(np.int32)
    q[:2] = KEY_MAX - 1
    want = j_leaf_slots_ref(jnp.asarray(rows), jnp.asarray(q))
    _eq(leaf_slots(_t(rows), _t(q)), want)
    _eq(leaf_slots_ref(_t(rows), _t(q)), want)


def _pool_case(rng, L, n_sep=120, ML=256, n_q=300):
    """A random leaf pool [ML, L] (sorted rows, KEY_MAX-padded tails),
    version heads, and an index over ``n_sep`` separators whose leaf ids
    include -1; queries hit pool keys, miss them, and include KEY_MAX - 1
    and KEY_MAX."""
    lk = np.sort(rng.integers(0, 10**6, (ML, L)), axis=1).astype(np.int32)
    lk[rng.random((ML, L)) < 0.2] = KEY_MAX
    lk = np.sort(lk, axis=1)
    lvh = rng.integers(-1, 5000, (ML, L)).astype(np.int32)
    seps = np.sort(rng.choice(10**6, n_sep, replace=False)).astype(np.int32)
    seps[0] = JI.KEY_MIN
    pad_k = np.full(ML, KEY_MAX, np.int32)
    pad_k[:n_sep] = seps
    pad_l = np.full(ML, -1, np.int32)
    pad_l[:n_sep] = rng.integers(-1, ML, n_sep)
    pad_l[:n_sep:7] = -1
    q = np.concatenate([
        rng.integers(-10, 10**6 + 10, n_q), lk[rng.integers(0, ML, 40), 0],
        lk[rng.integers(0, ML, 40), L // 2], [KEY_MAX - 1, KEY_MAX],
    ]).astype(np.int32)
    jidx = JI.build(JI.index_config(ML, 8), ML, pad_k, pad_l,
                    jnp.asarray(n_sep, jnp.int32))
    tidx = TI.build(TI.index_config(ML, 8), ML, _t(pad_k), _t(pad_l), n_sep)
    return jidx, tidx, lk, lvh, q


@functools.lru_cache(maxsize=None)
def _locate_case(L):
    """One pool case per width, shared by the tests below so the JAX side
    builds its index once per width."""
    return _pool_case(np.random.default_rng(L + 5), L)


@functools.lru_cache(maxsize=None)
def _jax_locate(L, backend):
    """The JAX package's ``locate`` on :func:`_locate_case`, as numpy:
    compiled once per (width, backend) for the module."""
    jidx, _, lk, lvh, q = _locate_case(L)
    return tuple(np.asarray(x) for x in JB.locate(
        jidx, jnp.asarray(lk), jnp.asarray(lvh), jnp.asarray(q),
        backend=backend))


@pytest.mark.parametrize("backend", [JB.XLA, JB.PALLAS_INTERPRET])
@pytest.mark.parametrize("L", [8, 16, 40])
def test_leaf_slots_at_matches_jax_locate(backend, L):
    """The in-place rank (wrapper on the CPU, and its twin) against the
    JAX package's ``locate`` with its two gathers: the same (slot, exists,
    vhead) for leaf ids from the descent, -1 among them; the wrapper's
    fourth output is the read of those heads."""
    _, tidx, lk, lvh, q = _locate_case(L)
    want = _jax_locate(L, backend)
    _, _, leaf_id = index_descend(tidx.node_keys, tidx.node_child, _t(q))
    _eq(leaf_id, want[2])
    assert int((leaf_id == -1).sum()) > 0
    args = (_t(lk), _t(lvh), leaf_id, _t(q))
    pools, snap = _version_pools(np.random.default_rng(L), 5000, len(q))
    got = leaf_slots_at(*args, snap, *pools, max_chain=8)
    _eq(got[:3], want[3:])
    _eq(got[3], versioned_read_ref(_t(want[5]), snap, *pools, max_chain=8))
    _eq(leaf_slots_at_ref(*args), want[3:])


def _version_pools(rng, MV, P):
    """Random version pools [MV] (chains that may cycle, tombstones) and
    snapshots [P] that fall before, inside and after the chains' ts."""
    ts = rng.integers(0, 50, MV).astype(np.int32)
    nxt = rng.integers(-1, MV, MV).astype(np.int32)
    val = rng.integers(-2, 99, MV).astype(np.int32)
    val[::11] = TOMB
    snap = rng.integers(-3, 53, P).astype(np.int32)
    return tuple(_t(a) for a in (ts, nxt, val)), _t(snap)


@pytest.mark.parametrize("max_chain", [1, 16])
@pytest.mark.parametrize("L", [8, 16, 33, 40])
def test_leaf_slots_at_with_snapshot_is_rank_then_read(L, max_chain):
    """The fused entry (wrapper on the CPU, and its twin) equals the
    in-place rank followed by ``versioned_read`` of its version heads: the
    same three rank outputs and, fourth, the value at each query's
    snapshot, [P] and scalar.  Leaf ids -1 and past both ends; hits,
    misses, KEY_MAX - 1 and KEY_MAX."""
    rng = np.random.default_rng(L * 31 + max_chain)
    ML, MV, P = 64, 2000, 500
    lk = np.sort(rng.integers(0, 5000, (ML, L)), axis=1)
    lk[rng.random((ML, L)) < 0.1] = KEY_MAX
    lk = np.sort(lk, axis=1).astype(np.int32)
    lvh = rng.integers(-1, MV, (ML, L)).astype(np.int32)
    ids = rng.integers(-ML - 2, ML + 2, P).astype(np.int32)
    rows = lk[np.clip(np.where(ids < 0, ids + ML, ids), 0, ML - 1)]
    q = rng.integers(0, 5100, P).astype(np.int32)
    hit = rng.random(P) < 0.6
    q[hit] = rows[hit, rng.integers(0, L, P)[hit]]
    q[:2] = [KEY_MAX - 1, KEY_MAX]
    args = (_t(lk), _t(lvh), _t(ids), _t(q))
    rank = leaf_slots_at_ref(*args)
    pools, snap = _version_pools(rng, MV, P)
    for s in (snap, _t(40), _t([25])):
        want = versioned_read_ref(rank[2], s, *pools, max_chain=max_chain)
        assert int((want != -1).sum()) > 0
        for fn in (leaf_slots_at, leaf_slots_at_ref):
            _eq(fn(*args, s, *pools, max_chain=max_chain), (*rank, want))


@pytest.mark.parametrize("L", [8, 16, 40])
def test_locate_with_snapshot_reads_each_hit(L):
    """``backend.locate``: the descent and the in-place rank's twin, and
    the value at the snapshot, the composition the store ran before the
    fused entry (rank, mask, ``resolve``)."""
    _, tidx, lk, lvh, q = _locate_case(L)
    pools, snap = _version_pools(np.random.default_rng(L), 5000, len(q))
    desc = index_descend(tidx.node_keys, tidx.node_child, _t(q))
    plain = (*desc, *leaf_slots_at_ref(_t(lk), _t(lvh), desc[2], _t(q)))
    got = TB.locate(tidx, _t(lk), _t(lvh), _t(q), snap, pools, max_chain=8)
    _eq(got[:6], plain)
    _eq(got[6], TB.resolve(torch.where(plain[4], plain[5], -1), snap,
                           *pools, max_chain=8))


@pytest.mark.parametrize("L", [8, 16, 40])
def test_locate_matches_jax_locate(L):
    """The port's ``backend.locate`` on the CPU against the JAX package's
    ``locate``: all six of its outputs, exactly."""
    _, tidx, lk, lvh, q = _locate_case(L)
    pools, snap = _version_pools(np.random.default_rng(L), 5000, len(q))
    _eq(TB.locate(tidx, _t(lk), _t(lvh), _t(q), snap, pools,
                  max_chain=8)[:6], _jax_locate(L, JB.XLA))


def test_leaf_slots_at_ids_follow_jax_index():
    """Out-of-range leaf ids wrap once and clamp, as the JAX gathers do."""
    rng = np.random.default_rng(9)
    ML, L, P = 16, 8, 64
    lk = np.sort(rng.integers(0, 100, (ML, L)), axis=1).astype(np.int32)
    lvh = rng.integers(-1, 500, (ML, L)).astype(np.int32)
    ids = rng.integers(-ML - 3, ML + 3, P).astype(np.int32)
    q = lk[np.clip(np.where(ids < 0, ids + ML, ids), 0, ML - 1), 3]
    rows = np.asarray(jnp.asarray(lk)[jnp.asarray(ids)])
    want_slot, want_ex = j_leaf_slots_ref(jnp.asarray(rows), jnp.asarray(q))
    vrows = np.asarray(jnp.asarray(lvh)[jnp.asarray(ids)])
    at = np.minimum(np.asarray(want_slot), L - 1)
    want_vh = np.where(want_ex, vrows[np.arange(P), at], -1)
    pools, snap = _version_pools(rng, 500, P)
    got = leaf_slots_at(_t(lk), _t(lvh), _t(ids), _t(q), snap, *pools,
                        max_chain=4)
    _eq(got[:3], (want_slot, want_ex, want_vh))
    assert bool(got[1].all())


def test_descend_variant_follows_width_and_alignment():
    """16-byte loads need rows of a multiple of 4 int32 and 16-byte
    aligned bases; anything else takes the 4-byte variant."""
    assert _build.vec_for(16, 0x1000, 0x2000) == 4
    assert _build.vec_for(6, 0x1000, 0x2000) == 1
    assert _build.vec_for(16, 0x1000, 0x2004) == 1
    assert _build.vec_for(40, 0x1000) == 4


@pytest.mark.parametrize("MV,P,chain", [(128, 64, 4), (1024, 200, 16)])
def test_versioned_read_twin_matches_jax(MV, P, chain):
    """Random chains (they may cycle): the step bound is exactly
    ``max_chain``; tombstones and out-of-chain snapshots read NOT_FOUND."""
    rng = np.random.default_rng(MV + P + chain)
    ts = rng.integers(0, 50, MV).astype(np.int32)
    nxt = rng.integers(-1, MV, MV).astype(np.int32)
    val = rng.integers(0, 99, MV).astype(np.int32)
    val[::11] = TOMB
    vh = rng.integers(-1, MV, P).astype(np.int32)
    snap = rng.integers(-3, 50, P).astype(np.int32)
    want = j_versioned_read_ref(*(jnp.asarray(a) for a in
                                  (vh, snap, ts, nxt, val)), max_chain=chain)
    args = tuple(_t(a) for a in (vh, snap, ts, nxt, val))
    _eq(versioned_read(*args, max_chain=chain), want)
    _eq(versioned_read_ref(*args, max_chain=chain), want)


@pytest.mark.parametrize("MV,P,chain", [(128, 64, 4), (1024, 200, 16)])
def test_versioned_read_scalar_snapshot_equals_per_query(MV, P, chain):
    """One snapshot for all queries (a scalar, a [1] tensor, an expanded
    view) reads what the same snapshot repeated as [P] reads."""
    rng = np.random.default_rng(MV * 3 + P)
    pools, _ = _version_pools(rng, MV, P)
    vh = _t(rng.integers(-1, MV, P))
    for snap in (-3, 0, 17, 49):
        per_query = versioned_read(vh, _t(np.full(P, snap)), *pools,
                                   max_chain=chain)
        for s in (_t(snap), _t([snap]), _t(snap).expand(P)):
            _eq(versioned_read(vh, s, *pools, max_chain=chain), per_query)
            _eq(versioned_read_ref(vh, s, *pools, max_chain=chain),
                per_query)
        _eq(TB.resolve(vh, snap, *pools, max_chain=chain), per_query)


def test_snap_stride_follows_shape_and_layout():
    """A snapshot is one for all (stride 0) or one per query (stride 1);
    other shapes, strides, dtypes or devices are refused."""
    cpu = torch.device("cpu")
    assert _build.snap_stride("k", _t(5), 8, cpu) == 0
    assert _build.snap_stride("k", _t([5]), 8, cpu) == 0
    assert _build.snap_stride("k", _t(5).expand(8), 8, cpu) == 0
    assert _build.snap_stride("k", _t(np.arange(8)), 8, cpu) == 1
    for bad in (_t(np.arange(16))[::2], _t(np.arange(7)),
                _t(np.zeros((8, 1)))):
        with pytest.raises(ValueError, match="snap_ts"):
            _build.snap_stride("k", bad, 8, cpu)
    with pytest.raises(TypeError, match="int32"):
        _build.snap_stride("k", _t(np.arange(8), torch.int64), 8, cpu)
    # the backend hands the kernels a copy of a [P] view with any other
    # stride, and everything else as it came
    strided = _t(np.arange(16))[::2]
    fixed = TB._snapshot(strided, _t(np.arange(8)))
    assert _build.snap_stride("k", fixed, 8, cpu) == 1
    _eq(fixed, np.arange(0, 16, 2))
    for ok in (_t(5), _t([5]), _t(5).expand(8), _t(np.arange(8))):
        assert TB._snapshot(ok, fixed) is ok


@pytest.mark.parametrize("Q,Sw,ML,L,MV,chain", [
    (16, 2, 64, 8, 256, 4),
    (100, 4, 128, 16, 1024, 8),
    (257, 3, 64, 8, 512, 16),
])
def test_range_scan_twin_matches_jax(Q, Sw, ML, L, MV, chain):
    """Candidate keys AND snapshot-resolved values, with pvalid=False
    slots and inverted intervals."""
    rng = np.random.default_rng(Q + Sw + ML)
    args = _range_case(rng, Q, Sw, ML, L, MV)
    want = j_range_scan_ref(*(jnp.asarray(a) for a in args), max_chain=chain)
    targs = _torch_args(args)
    _eq(range_scan(*targs, max_chain=chain), want)
    _eq(range_scan_ref(*targs, max_chain=chain), want)


@pytest.mark.parametrize("kernel", ["index_descend", "leaf_slots",
                                    "versioned_read", "range_scan"])
def test_twin_matches_pallas_interpret(kernel):
    """One shape per kernel against the JAX Pallas kernel itself (interpret
    mode on the CPU)."""
    rng = np.random.default_rng(7)
    if kernel == "index_descend":
        jidx, tidx, q = _index_case(rng, 8, 200, 100)
        want = j_index_descend(jidx.node_keys, jidx.node_child,
                               jnp.asarray(q), block_q=64)
        got = index_descend(tidx.node_keys, tidx.node_child, _t(q))
    elif kernel == "leaf_slots":
        rows = np.sort(rng.integers(0, 500, (100, 32)), axis=1).astype(np.int32)
        q = rng.integers(0, 520, 100).astype(np.int32)
        want = j_leaf_slots(jnp.asarray(rows), jnp.asarray(q), block_q=32)
        got = leaf_slots(_t(rows), _t(q))
    elif kernel == "versioned_read":
        MV, P = 256, 100
        arrs = (rng.integers(-1, MV, P), rng.integers(0, 50, P),
                rng.integers(0, 50, MV), rng.integers(-1, MV, MV),
                rng.integers(0, 99, MV))
        arrs = tuple(np.asarray(a, np.int32) for a in arrs)
        want = j_versioned_read(*(jnp.asarray(a) for a in arrs),
                                max_chain=8, block_q=64)
        got = versioned_read(*(_t(a) for a in arrs), max_chain=8)
    else:
        args = _range_case(rng, 40, 2, 64, 8, 256)
        want = j_range_scan(*(jnp.asarray(a) for a in args), max_chain=8,
                            block_q=8)
        got = range_scan(*_torch_args(args), max_chain=8)
    _eq(got, want)


@pytest.mark.parametrize("n_dir,n_q,bq,bd", [
    (64, 16, 8, 16), (1000, 333, 64, 128), (4096, 256, 256, 512),
    (7, 5, 8, 8),
])
def test_search_positions_twin_matches_pallas_interpret(n_dir, n_q, bq, bd):
    """The flat-directory rank at the four sweep shapes of
    ``tests/test_kernels.py``: the Pallas kernel in interpret mode, its
    jnp oracle, the port's twin and its wrapper on the CPU agree exactly.
    Queries lie in the valid key domain (below KEY_MAX - 1, where the
    Pallas kernel's pad queries sit); the directory starts at KEY_MIN as
    a store's does, and queries below ``dir[0]`` would give 0."""
    rng = np.random.default_rng(n_dir * 7 + n_q)
    d = np.sort(rng.choice(10**6, n_dir, replace=False)).astype(np.int32)
    d[0] = -(2**31)
    q = rng.integers(-10, 10**6 + 10, n_q).astype(np.int32)
    q[: min(3, n_q)] = d[: min(3, n_q)]            # exact separator hits
    want = j_search_positions(jnp.asarray(d), jnp.asarray(q),
                              block_q=bq, block_dir=bd)
    _eq(j_search_positions_ref(jnp.asarray(d), jnp.asarray(q)), want)
    _eq(search_positions_ref(_t(d), _t(q)), want)
    _eq(search_positions(_t(d), _t(q)), want)


def test_search_positions_twin_matches_rank_right_of_store():
    """On the directory of a 50,000-key port store (CPU), the flat rank is
    ``max(rank_right - 1, 0)`` of the multi-level index that replaced the
    flat directory: the same leaf ordinal for every query."""
    import repro_torch.api as T
    from repro_torch.core.store import directory

    rng = np.random.default_rng(3)
    db = T.Uruv(T.UruvConfig(leaf_cap=64, max_leaves=2048,
                             max_versions=1 << 17), device="cpu")
    keys = rng.choice(2_000_000, 50_000, replace=False).astype(np.int32)
    for i in range(0, len(keys), 4096):
        db.insert(keys[i:i + 4096], keys[i:i + 4096] % 1000 + 1)
    dir_keys, _ = directory(db.store)
    assert len(dir_keys) == int(db.store.n_leaves) > 100
    q = np.concatenate([rng.integers(0, 2_000_000, 4096), dir_keys[1:65],
                        dir_keys[1:65] - 1, [0, KEY_MAX - 2]]).astype(np.int32)
    got = search_positions(_t(dir_keys), _t(q))
    want = (TI.rank_right(db.store.index, _t(q)) - 1).clamp_min(0)
    _eq(got, want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.maximum(np.searchsorted(dir_keys, q, "right") - 1, 0))


@pytest.mark.parametrize("n_real,n_pad,dups", [
    (22_430, (1 << 17) - 22_430, False),  # the main store's, at max_leaves
    (22_430, (1 << 17) - 22_430, True),
    (1 << 17, 0, True),
    ((1 << 17) - 1, 1, False),
    (38_401, 0, True),
    (1025, 3000, True),
    (1024, 0, False),
    (1, 0, False),
    (0, 64, False),
    (0, 0, False),
])
def test_search_positions_twin_matches_jax_ref_at_max_leaves(n_real, n_pad,
                                                            dups):
    """The flat-directory rank at the TPU kernel's own input size: a
    sorted directory of ``n_real`` keys padded with KEY_MAX (runs of equal
    keys where ``dups``), P = 4096 queries that hit every entry dir[128 k]
    and the key just below it, and KEY_MIN, KEY_MAX - 2, KEY_MAX - 1 and
    KEY_MAX.  The port's twin and its CPU wrapper equal the JAX package's
    ``search_positions_ref`` (``jnp.searchsorted``, not the Pallas
    interpreter): exact."""
    rng = np.random.default_rng(n_real * 5 + n_pad + dups)
    if dups:
        d = np.sort(rng.integers(-10**6, max(n_real // 8, 1), n_real))
    else:
        d = np.sort(rng.choice(10**7, n_real, replace=False))
    d = np.concatenate([d, np.full(n_pad, KEY_MAX)]).astype(np.int32)
    sp = d[::128].astype(np.int64)
    edges = np.concatenate([[-(2**31), KEY_MAX - 2, KEY_MAX - 1, KEY_MAX],
                            sp, sp - 1]).clip(-(2**31), KEY_MAX)
    q = rng.integers(-10**6 - 5, 10**7 + 5, 4096).astype(np.int32)
    q[:min(len(edges), 4096)] = edges[:4096]
    want = np.asarray(j_search_positions_ref(jnp.asarray(d), jnp.asarray(q)))
    _eq(search_positions_ref(_t(d), _t(q)), want)
    _eq(search_positions(_t(d), _t(q)), want)


def test_wrappers_count_no_launch_on_cpu():
    """A CPU tensor takes the plain twin: no kernel launch is counted."""
    before = dict(_build.launch_counts)
    rows = _t(np.sort(np.arange(32).reshape(4, 8), axis=1))
    leaf_slots(rows, _t([0, 5, 9, 40]))
    versioned_read(_t([-1, 0]), _t([3, 3]), _t([1]), _t([-1]), _t([7]),
                   max_chain=2)
    search_positions(_t([-5, 3, 9]), _t([0, 3, 100]))
    leaf_slots_at(rows, rows, _t([0, -1, 3, 2]), _t([0, 5, 9, 40]), _t(3),
                  _t([1]), _t([-1]), _t([7]), max_chain=2)
    assert dict(_build.launch_counts) == before


def test_wrappers_refuse_other_devices():
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        versioned_read(meta, meta, meta, meta, meta, max_chain=1)
