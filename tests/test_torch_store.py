"""The port's store passes against the JAX package's, on the CPU.

Both sides start from the same state (a JAX store carried across with
``repro_torch.core.store.from_numpy``) and take the same ``bulk_apply`` /
``bulk_lookup`` / ``bulk_range`` / ``range_query`` / ``compact`` /
``reindex`` / snapshot calls; every result and every store array must be
bit-equal, rejected passes (``ok=False`` with their oflow bits) and
duplicate-key update batches included.  The JAX side runs its ``xla``
backend at fixed widths so each function compiles once.
"""

import numpy as np
import pytest

from repro.core import batch as JB
from repro.core import store as JS
from repro.core.ref import (
    KEY_MAX, NOT_FOUND, OP_DELETE, OP_INSERT, OP_NOP, OP_SEARCH, TOMBSTONE,
    RefStore,
)

from repro_torch.core import batch as TB
from repro_torch.core import store as TS

from _torch_port import (  # noqa: F401  (fresh_jax_caches: autouse)
    assert_same_store, fresh_jax_caches, to_port,
)

W = 32
CFG = JS.UruvConfig(leaf_cap=8, max_leaves=128, max_versions=4096,
                    tracker_cap=16, max_chain=16, index_fanout=4)


def _plan(rng, universe=600, p_ins=0.5, p_del=0.2, width=W):
    r = rng.random(width)
    codes = np.where(r < p_ins, OP_INSERT,
                     np.where(r < p_ins + p_del, OP_DELETE,
                              np.where(r < 0.95, OP_SEARCH, OP_NOP)))
    keys = rng.integers(0, universe, width).astype(np.int32)
    keys[codes == OP_NOP] = KEY_MAX
    vals = rng.integers(1, 1000, width).astype(np.int32)
    return codes.astype(np.int32), keys, vals


def _ingest(rng, rounds, cfg=CFG):
    """The same rounds through both combining layers (slow path too)."""
    js = JS.create(cfg)
    ts = to_port(js)
    ref = RefStore()
    for _ in range(rounds):
        codes, keys, vals = _plan(rng)
        js, jr = JB._apply_rounds(js, codes, keys, vals, None, None,
                                  backend="xla")
        ts, tr = TB._apply_rounds(ts, codes, keys, vals, None, None)
        np.testing.assert_array_equal(np.asarray(jr), tr)
        want = ref.apply_batch(list(zip(codes.tolist(), keys.tolist(),
                                        vals.tolist())))
        np.testing.assert_array_equal(tr, want)
    assert_same_store(js, ts, "after ingest")
    return js, ts


@pytest.fixture(scope="module")
def stores():
    js, ts = _ingest(np.random.default_rng(5), 16)
    TS.check_invariants(ts)
    return js, ts


@pytest.mark.parametrize("light_path", [True, False])
def test_bulk_apply_matches_jax(stores, light_path):
    js, ts = stores
    rng = np.random.default_rng(11 + light_path)
    for it in range(4):
        codes, keys, vals = _plan(rng)
        js, jres, jok = JS.bulk_apply(js, codes, keys, vals, backend="xla",
                                      light_path=light_path)
        ts, tres, tok = TS.bulk_apply(ts, codes, keys, vals,
                                      light_path=light_path)
        assert bool(jok) == tok
        np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
        assert_same_store(js, ts, f"bulk_apply light={light_path} #{it}")


def test_duplicate_key_updates_match_jax(stores):
    """Many updates of few keys in one batch: in-batch predecessor values,
    chain links and the group's last vhead all agree."""
    js, ts = stores
    rng = np.random.default_rng(3)
    keys = rng.choice(np.arange(0, 600, 7), 6).astype(np.int32)[
        rng.integers(0, 6, W)]
    codes = rng.choice([OP_INSERT, OP_DELETE, OP_SEARCH], W,
                       p=[0.5, 0.25, 0.25]).astype(np.int32)
    vals = rng.integers(1, 50, W).astype(np.int32)
    js, jres, jok = JS.bulk_apply(js, codes, keys, vals, backend="xla")
    ts, tres, tok = TS.bulk_apply(ts, codes, keys, vals)
    assert bool(jok) and tok
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    assert_same_store(js, ts, "duplicate-key batch")


@pytest.mark.parametrize("what", ["leafbatch", "versions"])
def test_rejected_pass_matches_jax(what):
    """A rejected pass returns the input store with its oflow bits set and
    all-NOT_FOUND results — on both sides, array for array."""
    cfg = CFG if what == "leafbatch" else JS.UruvConfig(
        leaf_cap=8, max_leaves=128, max_versions=40, tracker_cap=16,
        max_chain=16, index_fanout=4)
    js = JS.create(cfg)
    ts = to_port(js)
    keys = np.arange(100, 100 + W, dtype=np.int32)   # > L new keys, one leaf
    codes = np.full(W, OP_INSERT, np.int32)
    if what == "versions":                            # fits, then overflows
        for k in (keys[:6], keys[6:12], keys[12:18]):
            c = np.full(len(k), OP_INSERT, np.int32)
            js, _, _ = JS.bulk_apply(js, c, k, k, backend="xla")
            ts, _, _ = TS.bulk_apply(ts, c, k, k)
        codes[:] = OP_DELETE
        keys = np.tile(keys[:8], 4)
    js2, jres, jok = JS.bulk_apply(js, codes, keys, keys, backend="xla")
    ts2, tres, tok = TS.bulk_apply(ts, codes, keys, keys)
    assert not bool(jok) and not tok
    bit = JS.OFLOW_LEAFBATCH if what == "leafbatch" else JS.OFLOW_VERSIONS
    assert int(ts2.oflow) & bit
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    assert np.all(tres.numpy() == NOT_FOUND)
    assert_same_store(js2, ts2, f"rejected ({what})")
    assert_same_store(js, ts, "input untouched")


def test_reads_match_jax(stores):
    js, ts = stores
    rng = np.random.default_rng(9)
    now = int(ts.ts)
    q = rng.integers(0, 700, W).astype(np.int32)
    q[:2] = KEY_MAX
    for snap in (now, now - 40, np.arange(now - W, now, dtype=np.int32)):
        np.testing.assert_array_equal(
            np.asarray(JS.bulk_lookup(js, q, snap, backend="xla")),
            TS.bulk_lookup(ts, q, snap).numpy())
    k1 = rng.integers(0, 600, 8).astype(np.int32)
    k2 = (k1 + rng.integers(-20, 300, 8)).astype(np.int32)   # some inverted
    snap = rng.integers(now - 60, now + 1, 8).astype(np.int32)
    for R, S, rounds in ((32, 2, 3), (4, 1, 1)):     # truncation + resume
        a = JS.bulk_range(js, k1, k2, snap, max_results=R, scan_leaves=S,
                          max_rounds=rounds, backend="xla")
        b = TS.bulk_range(ts, k1, k2, snap, max_results=R, scan_leaves=S,
                          max_rounds=rounds)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for lo, hi, sl in ((100, 400, 8), (0, 700, 2), (650, 10, 4)):
        a = JS.range_query(js, lo, hi, now - 30, max_scan_leaves=sl,
                           max_results=64, backend="xla")
        b = TS.range_query(ts, lo, hi, now - 30, max_scan_leaves=sl,
                           max_results=64)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        assert int(JS.scan_resume_sep(js, lo, sl, hi)) == int(
            TS.scan_resume_sep(ts, lo, sl, hi))
    assert JS.live_items(js) == TS.live_items(ts)


def test_snapshots_compact_reindex_match_jax(stores):
    js, ts = stores
    js, s1 = JS.snapshot(js)
    ts, t1 = TS.snapshot(ts)
    assert int(s1) == int(t1)
    assert int(JS.min_active_ts(js)) == int(TS.min_active_ts(ts))
    rng = np.random.default_rng(21)
    codes, keys, vals = _plan(rng)
    js, _, _ = JS.bulk_apply(js, codes, keys, vals, backend="xla")
    ts, _, _ = TS.bulk_apply(ts, codes, keys, vals)
    jc, jn = JS.compact(js)
    tc, tn = TS.compact(ts)
    assert int(jn) == int(tn)
    assert_same_store(jc, tc, "compact under a held snapshot")
    TS.check_invariants(tc)
    js, ts = JS.release(jc, s1), TS.release(tc, t1)
    assert_same_store(js, ts, "release")
    jc, jn = JS.compact(js)
    tc, tn = TS.compact(ts)
    assert int(jn) == int(tn)
    assert_same_store(jc, tc, "compact")
    assert_same_store(JS.reindex(jc), TS.reindex(tc), "reindex")
    # the tracker ring: fill it past capacity (OFLOW_TRACKER)
    for _ in range(CFG.tracker_cap + 1):
        jc, _ = JS.snapshot(jc)
        tc, _ = TS.snapshot(tc)
    assert int(tc.oflow) & TS.OFLOW_TRACKER
    assert_same_store(jc, tc, "tracker overflow")


def test_slow_path_matches_jax():
    """Tiny leaves force the OFLOW_LEAFBATCH halving path: the combining
    layers agree on results, per-op timestamps and the final store."""
    cfg = JS.UruvConfig(leaf_cap=4, max_leaves=256, max_versions=4096,
                        tracker_cap=16, max_chain=16, index_fanout=4)
    js = JS.create(cfg)
    ts = to_port(js)
    rng = np.random.default_rng(17)
    jstats, tstats = {}, {}
    for _ in range(3):
        keys = rng.choice(5000, W, replace=False).astype(np.int32)
        codes = np.full(W, OP_INSERT, np.int32)
        js, jr = JB._apply_rounds(js, codes, keys, keys, None, None,
                                  backend="xla", stats=jstats)
        ts, tr = TB._apply_rounds(ts, codes, keys, keys, None, None,
                                  stats=tstats)
        np.testing.assert_array_equal(np.asarray(jr), tr)
    assert tstats == jstats and tstats["slow_path_rounds"] > 0
    assert_same_store(js, ts, "after halving")
    TS.check_invariants(ts)


def test_store_round_trips_through_numpy(stores):
    js, ts = stores
    back = TS.from_numpy(TS.to_numpy(ts), ts.cfg, "cpu")
    assert_same_store(js, back, "round trip")
    assert TS.derive_update_codes([1, KEY_MAX, 3], [5, 5, TOMBSTONE]).tolist() \
        == [OP_INSERT, OP_NOP, OP_DELETE]


def test_create_defaults_to_cuda():
    """No silent CPU fallback: without a card the default device raises."""
    import torch

    if torch.cuda.is_available():
        assert TS.create(CFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.create(CFG)
