"""The port's ``Uruv`` client against the JAX package's, on the CPU.

The port's ``Uruv(device="cpu")`` and the JAX ``Uruv`` under the same
fixed-footprint policy (``backend="xla"``) run the same mixed plans —
RANGE ops, held snapshots, the halving slow path of a tiny ``leaf_cap`` —
and must return the same ``Result`` values, timestamps and pages, the same
pages and lookups at held snapshots, the same counters and the same final
store; ``RefStore`` is the oracle for both.
"""

import numpy as np
import pytest

from repro.api import (
    CapacityError as JCapacityError, LifecyclePolicy as JPolicy,
    OpBatch as JOpBatch, Uruv as JUruv, UruvConfig as JConfig,
    make_result as j_make_result,
)
from repro.core.ref import KEY_MAX, OP_DELETE, OP_INSERT, OP_SEARCH, RefStore

import repro_torch.api as T

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    assert_same_store, bounded_jax_maps, fresh_jax_caches,
)

CFG = dict(leaf_cap=8, max_leaves=256, max_versions=1 << 12, tracker_cap=16,
           max_chain=16, index_fanout=4)
FIXED = JPolicy(auto_grow=False, auto_maintain=False)


def _pair(**over):
    cfg = dict(CFG, **over)
    return (JUruv(JConfig(**cfg), policy=FIXED, backend="xla"),
            T.Uruv(T.UruvConfig(**cfg), device="cpu",
                   policy=T.FIXED_FOOTPRINT))


def _crud(rng, n, universe=500):
    r = rng.random(n)
    codes = np.where(r < 0.5, OP_INSERT,
                     np.where(r < 0.7, OP_DELETE, OP_SEARCH)).astype(np.int32)
    keys = rng.integers(0, universe, n).astype(np.int32)
    vals = rng.integers(1, 10_000, n).astype(np.int32)
    return codes, keys, vals


def _plans(rng, n_plans):
    """Plans of one fixed layout (16 CRUD, 2 RANGE, 14 CRUD): every JAX
    pass keeps its width, so each compiles once."""
    for _ in range(n_plans):
        a, b = _crud(rng, 16), _crud(rng, 14)
        lo = rng.integers(0, 500, 2).astype(np.int32)
        hi = (lo + rng.integers(-10, 200, 2)).astype(np.int32)
        yield [(a, None), (None, (lo, hi)), (b, None)]


def _build(cls, layout):
    return cls.concat(*(cls(*crud) if crud is not None
                        else cls.ranges(*rng_ops) for crud, rng_ops in layout))


def _same_result(j, t):
    for f in ("values", "found", "timestamps", "range_index", "range_resume"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f), err_msg=f)
    assert j.pages() == t.pages()


def _same_page(jp, tp):
    for f in ("keys", "values", "count", "truncated", "resume_k1"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)


def test_client_matches_jax_and_refstore():
    jdb, tdb = _pair()
    ref = RefStore()
    rng = np.random.default_rng(42)
    held = None
    for i, layout in enumerate(_plans(rng, 8)):
        jb, tb = _build(JOpBatch, layout), _build(T.OpBatch, layout)
        jr, tr = jdb.apply(jb), tdb.apply(tb)
        _same_result(jr, tr)
        ops = [(int(c), int(k), int(v))
               for c, k, v in zip(tb.codes, tb.keys, tb.values)]
        np.testing.assert_array_equal(tr.values, ref.apply_batch(ops))
        if i == 3:                              # a snapshot held across plans
            held = (jdb.acquire_snapshot(), tdb.acquire_snapshot())
            assert held[0] == held[1]
            ref.snapshot()
            held_ref = {k: ref.search_at(k, held[1]) for k in range(500)}
    assert jdb.ts == tdb.ts
    assert held is not None
    lo = np.array([0, 100, 250, 400], np.int32)
    hi = lo + 120
    pages = tdb.range_all(lo, hi, held[1])
    assert jdb.range_all(lo, hi, held[0]) == pages
    for a, b in zip(lo.tolist(), pages):
        assert b == [(k, v) for k, v in sorted(held_ref.items())
                     if a <= k <= a + 120 and v != -1]
    probe = np.arange(0, 500, 3, dtype=np.int32)
    np.testing.assert_array_equal(jdb.lookup(probe, held[0]),
                                  tdb.lookup(probe, held[1]))
    _same_page(jdb.range_page(lo, hi, held[0], max_results=8, scan_leaves=1,
                              max_rounds=1),
               tdb.range_page(lo, hi, held[1], max_results=8, scan_leaves=1,
                              max_rounds=1))
    _same_page(jdb.scan_page(50, 450, held[0], max_scan_leaves=4,
                             max_results=16),
               tdb.scan_page(50, 450, held[1], max_scan_leaves=4,
                             max_results=16))
    jdb.release_snapshot(held[0])
    tdb.release_snapshot(held[1])
    with jdb.snapshot() as jts, tdb.snapshot() as tts:
        assert jts == tts
        assert tdb.range(0, 499, tts) == jdb.range(0, 499, jts)
    assert jdb.compact() == tdb.compact()
    jdb.reindex()
    tdb.reindex()
    assert_same_store(jdb.store, tdb.store, "client after compact/reindex")
    assert tdb.live_items() == jdb.live_items() == ref.live_items()
    assert len(tdb) == len(jdb)
    js, ts_ = jdb.stats, tdb.stats
    for k in ("device_passes", "slow_path_rounds", "compactions",
              "index_delta_passes", "index_propagations"):
        assert js[k] == ts_[k], k
    assert ts_["slow_path_rounds"] > 0          # leaf_cap 8 halved plans


def test_tiny_leaf_cap_halving_matches_jax():
    """leaf_cap=4 forces OFLOW_LEAFBATCH halving on most plans: results,
    per-op timestamps and the store still agree."""
    jdb, tdb = _pair(leaf_cap=4, max_leaves=512)
    rng = np.random.default_rng(8)
    for _ in range(3):
        keys = rng.choice(3000, 16, replace=False).astype(np.int32)
        _same_result(jdb.insert(keys, keys + 1), tdb.insert(keys, keys + 1))
        _same_result(jdb.search(keys), tdb.search(keys))
    assert tdb.stats["slow_path_rounds"] == jdb.stats["slow_path_rounds"] > 0
    assert_same_store(jdb.store, tdb.store, "after halving")


def test_fixed_footprint_capacity_error_matches_jax():
    jdb, tdb = _pair(max_versions=24)
    keys = np.arange(16, dtype=np.int32)
    jdb.insert(keys, keys)
    tdb.insert(keys, keys)
    with pytest.raises(JCapacityError) as je:
        jdb.insert(keys, keys + 1)
    with pytest.raises(T.CapacityError) as te:
        tdb.insert(keys, keys + 1)
    assert je.value.oflow == te.value.oflow != 0


def test_policy_and_device_guards():
    import torch

    # the default policy is self-sizing: the same ingest that overflows a
    # fixed footprint grows the pools instead
    tiny = dict(CFG, max_leaves=8, max_versions=64)
    keys = np.arange(64, dtype=np.int32)
    db = T.Uruv(T.UruvConfig(**tiny), device="cpu")
    assert db.executor.policy == T.LifecyclePolicy()
    for i in range(0, 64, 8):
        db.insert(keys[i:i + 8], keys[i:i + 8])
    assert db.stats["grows"] > 0 and db.capacity.max_leaves > 8
    assert db.live_items() == [(int(k), int(k)) for k in keys]
    fixed = T.Uruv(T.UruvConfig(**tiny), device="cpu",
                   policy=T.FIXED_FOOTPRINT)
    with pytest.raises(T.CapacityError):
        for i in range(0, 64, 8):
            fixed.insert(keys[i:i + 8], keys[i:i + 8])
    assert fixed.capacity.max_leaves == 8
    assert T.Uruv(T.UruvConfig(**CFG), device="cpu",
                  policy=T.FIXED_FOOTPRINT).ts == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.Uruv(T.UruvConfig(**CFG))


def test_opbatch_and_result_match_jax():
    rng = np.random.default_rng(1)
    k = rng.integers(0, 100, 5).astype(np.int32)
    pairs = [
        (JOpBatch.inserts(k, 7), T.OpBatch.inserts(k, 7)),
        (JOpBatch.deletes(k), T.OpBatch.deletes(k)),
        (JOpBatch.searches(k), T.OpBatch.searches(k)),
        (JOpBatch.ranges(k, k + 9), T.OpBatch.ranges(k, k + 9)),
        (JOpBatch.updates(np.r_[k, KEY_MAX], np.r_[k, -(2**31) + 1]),
         T.OpBatch.updates(np.r_[k, KEY_MAX], np.r_[k, -(2**31) + 1])),
        (JOpBatch.from_ops([(0, 1, 2), (4, 3, 9)]),
         T.OpBatch.from_ops([(0, 1, 2), (4, 3, 9)])),
    ]
    pairs.append((JOpBatch.concat(*(p[0] for p in pairs)).pad_to_pow2(),
                  T.OpBatch.concat(*(p[1] for p in pairs)).pad_to_pow2()))
    for j, t in pairs:
        for f in ("codes", "keys", "values"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f))
        np.testing.assert_array_equal(j.range_positions, t.range_positions)
    for bad in (KEY_MAX, KEY_MAX - 1):
        with pytest.raises(ValueError):
            T.OpBatch.inserts([bad], [1])
    with pytest.raises(ValueError):
        T.Uruv(T.UruvConfig(**CFG), device="cpu").lookup([KEY_MAX - 1])
    items = [(2, [(1, 5), (3, 6)], 9)]
    _same_result(j_make_result(np.array([4, -1, 2]), np.array([0, 2, 4]), 10,
                               items),
                 T.make_result(np.array([4, -1, 2]), np.array([0, 2, 4]), 10,
                               items))
    assert [T.pow2_width(n) for n in (0, 1, 5, 64)] == [1, 1, 8, 64]
