"""The port's flat-array baseline against the JAX package's, on the CPU.

``repro_torch.core.baseline`` (``FlatStore``, ``bulk_update``,
``bulk_lookup``, ``range_scan``, ``range_query_validated``) must be
bit-equal to ``repro.core.baseline`` after every batch of a seeded
sequence: duplicate keys inside a batch (the later row wins), deletes of
absent keys, ``KEY_MAX`` rows (dropped), and batches that fill the
capacity and overflow it.  Shapes stay fixed so each JAX function
compiles once.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs import uruv_paper as JW
from repro.core import baseline as JBL
from repro.core.ref import KEY_MAX, TOMBSTONE

from repro_torch.configs import uruv_paper as TW
from repro_torch.core import baseline as TBL

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

CAP = 64
P = 16


def _same(t: TBL.FlatStore, j: JBL.FlatStore):
    assert t.capacity == j.capacity
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    assert int(t.count) == int(j.count)


def _batches(rng, n, universe):
    """Seeded update batches: inserts, deletes (also of absent keys),
    duplicate keys inside a batch and KEY_MAX rows."""
    out = []
    for i in range(n):
        keys = rng.integers(0, universe, P).astype(np.int32)
        keys[rng.integers(0, P, 3)] = keys[0]            # duplicates
        keys[rng.random(P) < 0.1] = KEY_MAX              # masked rows
        vals = (keys % 1000 + 1 + i).astype(np.int32)
        dels = rng.random(P) < 0.3
        vals[dels] = TOMBSTONE
        if i % 3 == 2:                                   # absent keys
            keys[:4] = universe + np.arange(4, dtype=np.int32)
            vals[:4] = TOMBSTONE
        out.append((keys, vals))
    return out


def _queries(rng, universe):
    q = rng.integers(0, universe + 4, P).astype(np.int32)
    q[0] = KEY_MAX
    return q


@pytest.mark.parametrize("seed,universe", [(0, 48), (1, 200), (2, 1 << 20)])
def test_flatstore_bit_equal_after_every_batch(seed, universe):
    """Every batch: the arrays and count, lookups, and a range scan; a
    universe of 200 overflows the 64 slots (count > capacity, as JAX)."""
    rng = np.random.default_rng(seed)
    t, j = TBL.create(CAP, device="cpu"), JBL.create(CAP)
    _same(t, j)
    for keys, vals in _batches(rng, 12, universe):
        t = TBL.bulk_update(t, keys, vals)
        j = JBL.bulk_update(j, jnp.asarray(keys), jnp.asarray(vals))
        _same(t, j)
        q = _queries(rng, universe)
        np.testing.assert_array_equal(TBL.bulk_lookup(t, q).numpy(),
                                      np.asarray(JBL.bulk_lookup(j, q)))
        k1 = int(rng.integers(0, universe))
        k2 = k1 + int(rng.integers(0, universe // 2 + 1))
        for got, want in zip(TBL.range_scan(t, k1, k2, max_results=32),
                             JBL.range_scan(j, k1, k2, max_results=32)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flatstore_fills_capacity_exactly():
    """A batch that fills every slot, then one that overflows it, then
    deletes that free room again."""
    keys = np.arange(CAP, dtype=np.int32)[::-1].copy()
    t, j = TBL.create(CAP, device="cpu"), JBL.create(CAP)
    for lo in range(0, CAP, P):
        k = keys[lo:lo + P]
        t = TBL.bulk_update(t, k, k + 1)
        j = JBL.bulk_update(j, jnp.asarray(k), jnp.asarray(k + 1))
        _same(t, j)
    assert int(t.count) == CAP and int((t.keys < KEY_MAX).sum()) == CAP
    extra = np.arange(CAP, CAP + P, dtype=np.int32)
    t = TBL.bulk_update(t, extra, extra)
    j = JBL.bulk_update(j, jnp.asarray(extra), jnp.asarray(extra))
    _same(t, j)
    assert int(t.count) == CAP + P
    gone = np.arange(P, dtype=np.int32)
    t = TBL.bulk_update(t, gone, np.full(P, TOMBSTONE, np.int32))
    j = JBL.bulk_update(j, jnp.asarray(gone),
                        jnp.full((P,), TOMBSTONE, jnp.int32))
    _same(t, j)


@pytest.mark.parametrize("interleaved", [False, True])
def test_range_query_validated_matches_jax(interleaved):
    """Results and scan counts: 2 scans on a quiescent store; under an
    updater that changes the range between scans, the retries JAX makes."""
    rng = np.random.default_rng(7)
    t, j = TBL.create(CAP, device="cpu"), JBL.create(CAP)
    for keys, vals in _batches(rng, 4, 100):
        t = TBL.bulk_update(t, keys, vals)
        j = JBL.bulk_update(j, jnp.asarray(keys), jnp.asarray(vals))
    upd = [(np.full(P, 10 + i, np.int32), np.full(P, 500 + i, np.int32))
           for i in range(5)]

    def refs(store, update):
        box = {"st": store, "n": 0}

        def ref():
            if interleaved and box["n"] < len(upd):
                k, v = upd[box["n"]]
                box["st"] = update(box["st"], k, v)
            box["n"] += 1
            return box["st"]
        return ref

    got = TBL.range_query_validated(
        refs(t, TBL.bulk_update), 0, 60, max_results=32)
    want = JBL.range_query_validated(
        refs(j, lambda s, k, v: JBL.bulk_update(s, jnp.asarray(k),
                                                jnp.asarray(v))),
        0, 60, max_results=32)
    assert got == want
    assert got[1] == (len(upd) + 1 if interleaved else 2)
    assert all(isinstance(x, int) for kv in got[0] for x in kv)


def test_uruv_workload_fields_match_jax():
    """``configs/uruv_paper``: the same fields and defaults as JAX's."""
    t, j = TW.config(), JW.config()
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t.store) == dataclasses.asdict(j.store)
    for f in dataclasses.fields(t):
        if f.name != "store":
            assert getattr(t, f.name) == getattr(j, f.name)


def test_create_defaults_to_cuda():
    """No device means the card: without one it raises, never a silent
    CPU store."""
    if torch.cuda.is_available():
        assert TBL.create(CAP).keys.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TBL.create(CAP)
