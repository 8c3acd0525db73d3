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

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import index as JI
from repro.core.ref import KEY_MAX
from repro.kernels.uruv_range.ref import range_scan_ref as j_range_scan_ref
from repro.kernels.uruv_range.uruv_range import range_scan as j_range_scan
from repro.kernels.uruv_search.ref import (
    index_descend_ref as j_index_descend_ref, leaf_slots_ref as j_leaf_slots_ref,
)
from repro.kernels.uruv_search.uruv_search import (
    index_descend as j_index_descend, leaf_slots as j_leaf_slots,
)
from repro.kernels.versioned_read.ref import (
    versioned_read_ref as j_versioned_read_ref,
)
from repro.kernels.versioned_read.versioned_read import (
    versioned_read as j_versioned_read,
)

from repro_torch.core import index as TI
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

from _torch_port import fresh_jax_caches  # noqa: F401  (autouse)

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


def test_wrappers_count_no_launch_on_cpu():
    """A CPU tensor takes the plain twin: no kernel launch is counted."""
    before = dict(_build.launch_counts)
    rows = _t(np.sort(np.arange(32).reshape(4, 8), axis=1))
    leaf_slots(rows, _t([0, 5, 9, 40]))
    versioned_read(_t([-1, 0]), _t([3, 3]), _t([1]), _t([-1]), _t([7]),
                   max_chain=2)
    assert dict(_build.launch_counts) == before


def test_wrappers_refuse_other_devices():
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        versioned_read(meta, meta, meta, meta, meta, max_chain=1)
