"""The port's fat-node index against the JAX package's, on the CPU.

Mirrors tests/test_index.py: both indexes are built from the same
separators and driven with the same split deltas; every ``UruvIndex``
field, the descent and the rank/select helpers must be bit-equal, and the
port's own ``check_index`` must hold after every step.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import index as JI
from repro.core.ref import KEY_MAX

from repro_torch.core import index as TI

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    assert_same_arrays, bounded_jax_maps, fresh_jax_caches,
)


_j_split = jax.jit(JI.apply_split_delta)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _jax_fields(idx):
    out = {}
    for f in dataclasses.fields(idx):
        if f.name == "cfg":
            continue
        v = getattr(idx, f.name)
        if isinstance(v, tuple):
            out.update({f"{f.name}.{l}": np.asarray(a) for l, a in enumerate(v)})
        else:
            out[f.name] = np.asarray(v)
    return out


def _port_fields(idx):
    out = {}
    for f in dataclasses.fields(idx):
        if f.name == "cfg":
            continue
        v = getattr(idx, f.name)
        if isinstance(v, list):
            out.update({f"{f.name}.{l}": a.numpy() for l, a in enumerate(v)})
        else:
            out[f.name] = v.numpy()
    return out


def _same_index(jidx, tidx, where=""):
    assert tidx.cfg == TI.IndexConfig(jidx.cfg.fanout, jidx.cfg.depth,
                                      jidx.cfg.caps)
    assert_same_arrays(_jax_fields(jidx), _port_fields(tidx), where)


def _build_pair(seps, leaves, ML, fanout):
    n_sep = len(seps)
    pad_k = np.full(ML, KEY_MAX, np.int32)
    pad_k[:n_sep] = seps
    pad_l = np.full(ML, -1, np.int32)
    pad_l[:n_sep] = leaves
    jidx = JI.build(JI.index_config(ML, fanout), ML, pad_k, pad_l,
                    jnp.asarray(n_sep, jnp.int32))
    tidx = TI.build(TI.index_config(ML, fanout), ML, _t(pad_k), _t(pad_l),
                    n_sep)
    return jidx, tidx


@pytest.mark.parametrize("n_sep,fanout", [(1, 4), (3, 4), (40, 4),
                                          (200, 8), (250, 16)])
def test_build_and_queries_match_jax(n_sep, fanout):
    rng = np.random.default_rng(n_sep * 31 + fanout)
    ML = 256
    seps = np.sort(rng.choice(100_000, n_sep, replace=False)).astype(np.int32)
    seps[0] = JI.KEY_MIN
    leaves = rng.permutation(ML)[:n_sep].astype(np.int32)
    jidx, tidx = _build_pair(seps, leaves, ML, fanout)
    _same_index(jidx, tidx, "build")
    TI.check_index(tidx, n_sep)

    q = np.concatenate([
        rng.integers(-1000, 101_000, 256).astype(np.int32),
        seps, seps + 1, seps - 1,
        np.array([JI.KEY_MIN, JI.KEY_MIN + 1, KEY_MAX - 1], np.int32),
    ])
    jq, tq = jnp.asarray(q), _t(q)
    jb = JI.descend(jidx, jq)
    tb = TI.descend(tidx, tq)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(JI.leaf_ordinal(jidx, jb[0], jb[1])),
        TI.leaf_ordinal(tidx, tb[0], tb[1]).numpy())
    np.testing.assert_array_equal(np.asarray(JI.rank_right(jidx, jq)),
                                  TI.rank_right(tidx, tq).numpy())
    p = np.arange(-2, n_sep + 3, dtype=np.int32)
    for jf, tf in ((JI.leaf_at, TI.leaf_at), (JI.sep_at, TI.sep_at)):
        np.testing.assert_array_equal(np.asarray(jf(jidx, jnp.asarray(p))),
                                      tf(tidx, _t(p)).numpy())
    for a, b in zip(JI.ord_locate(jidx, jnp.asarray(p)),
                    TI.ord_locate(tidx, _t(p))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(JI.directory(jidx, n_sep), TI.directory(tidx, n_sep)):
        np.testing.assert_array_equal(a, b)


def test_depth1_build_matches_jax():
    """ML <= F: a depth-1 index packs every separator into the root."""
    ML = F = 16
    seps = (np.arange(16, dtype=np.int64) * 10).astype(np.int32)
    seps[0] = JI.KEY_MIN
    jidx, tidx = _build_pair(seps, np.arange(16, dtype=np.int32), ML, F)
    assert tidx.cfg.depth == 1
    _same_index(jidx, tidx, "depth-1 build")
    TI.check_index(tidx, 16)


def _split_delta(rng, dirk, dirl, n_alloc, P, n_split):
    """One structural batch's split delta in the store's layout: groups
    in key order at the front, invalid padding after them."""
    n = len(dirk)
    cands = []
    for p in sorted(rng.choice(n, min(n_split, n), replace=False).tolist()):
        lo = max(int(dirk[p]), -1)
        hi = int(dirk[p + 1]) if p + 1 < n else lo + 100_000
        if hi - lo >= 2:
            cands.append((p, lo, hi))
    valid = np.zeros(P, bool)
    gkey = np.full(P, KEY_MAX, np.int32)
    old_leaf = np.zeros(P, np.int32)
    left = np.full(P, 4096, np.int32)
    right = np.full(P, 4096, np.int32)
    rkey = np.full(P, KEY_MAX, np.int32)
    for g, (p, lo, hi) in enumerate(cands):
        valid[g] = True
        gkey[g] = dirk[p]
        old_leaf[g] = dirl[p]
        left[g] = n_alloc + 2 * g
        right[g] = n_alloc + 2 * g + 1
        rkey[g] = rng.integers(lo + 1, hi)
    return (valid, gkey, old_leaf, left, right, rkey), n_alloc + 2 * len(cands)


@pytest.mark.parametrize("fanout", [4, 8])
def test_split_deltas_match_jax(fanout):
    """A chain of split deltas (node splits propagating upward at small
    fanout) leaves both indexes bit-equal after every step; the reindex
    repack agrees too."""
    rng = np.random.default_rng(100 + fanout)
    ML, P = 4096, 16
    n_sep = 30
    seps = np.sort(rng.choice(10**7, n_sep, replace=False)).astype(np.int32)
    seps[0] = JI.KEY_MIN
    jidx, tidx = _build_pair(seps, np.arange(n_sep, dtype=np.int32), ML,
                             fanout)
    n_alloc = n_sep
    for step in range(12):
        dirk, dirl = TI.directory(tidx, n_sep)
        delta, n_alloc = _split_delta(rng, dirk, dirl, n_alloc, P,
                                      int(rng.integers(1, P)))
        jidx, jo = _j_split(jidx, *(jnp.asarray(a) for a in delta))
        tidx, to = TI.apply_split_delta(
            tidx, torch.as_tensor(delta[0]), *(_t(a) for a in delta[1:]))
        assert bool(jo) == bool(to) is False
        n_sep += int(delta[0].sum())
        _same_index(jidx, tidx, f"delta step {step}")
        TI.check_index(tidx, n_sep)
    assert int(tidx.stat_propagations) > 0
    _same_index(JI.reindex(jidx, jnp.asarray(n_sep, jnp.int32), ML),
                TI.reindex(tidx, n_sep, ML), "reindex")


def test_split_delta_overflow_matches_jax():
    """More node splits than free pool slots: both report oflow, and the
    input index is left intact (callers discard the result)."""
    ML, F = 256, 4
    n_sep = 250
    seps = np.arange(n_sep, dtype=np.int32) * 10
    seps[0] = JI.KEY_MIN
    leaves = np.arange(n_sep, dtype=np.int32)
    jidx, tidx = _build_pair(seps, leaves, ML, F)
    delta = (np.ones(n_sep, bool), seps, leaves, leaves + 1000,
             leaves + 5000, seps + 5)
    _, jo = _j_split(jidx, *(jnp.asarray(a) for a in delta))
    _, to = TI.apply_split_delta(tidx, torch.as_tensor(delta[0]),
                                 *(_t(a) for a in delta[1:]))
    assert bool(jo) and bool(to)
    TI.check_index(tidx, n_sep)
    _same_index(jidx, tidx, "input after rejected delta")
