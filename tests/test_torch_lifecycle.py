"""The port's store lifecycle against the JAX package's, on the CPU.

Mirrors the non-sharded cases of ``tests/test_lifecycle.py`` (all but the
checkpoint round-trip, whose subsystem is not ported): the same schedule
of plans, grows and maintain passes runs through the JAX client
(``backend="xla"``) and the port's client on ``device="cpu"``, and must
give the same results and bit-equal store arrays; held snapshots read the
same before and after every pass.  ``RefStore`` is the oracle.
"""

import dataclasses

import numpy as np
import pytest

from repro import api as J
from repro.core import lifecycle as JLC
from repro.core.ref import OP_DELETE, OP_INSERT, OP_SEARCH, RefStore

import repro_torch.api as T
from repro_torch.core import lifecycle as LC
from repro_torch.core import store as TS

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    assert_same_store, fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

FIXED = dict(auto_grow=False, auto_maintain=False)


def _cfg(**kw):
    base = dict(leaf_cap=8, max_leaves=64, max_versions=1 << 11,
                tracker_cap=16, max_chain=16)
    base.update(kw)
    return base


def _pair(policy=None, **cfg):
    jp = None if policy is None else J.LifecyclePolicy(**policy)
    tp = None if policy is None else T.LifecyclePolicy(**policy)
    return (J.Uruv(J.UruvConfig(**_cfg(**cfg)), policy=jp, backend="xla"),
            T.Uruv(T.UruvConfig(**_cfg(**cfg)), policy=tp, device="cpu"))


def _same(jdb, tdb, where=""):
    assert_same_store(jdb.store, tdb.store, where)
    assert jdb.capacity == tdb.capacity or (
        jdb.capacity.__dict__ == tdb.capacity.__dict__)


def _assert_accounting(store):
    acc = LC.leaf_accounting(store)
    assert acc["n_alloc"] == acc["live"] + acc["dead"], acc
    frozen = store.leaf_frozen.numpy()
    refd = store.index.leaf_ent.numpy() >= 0
    assert not frozen[refd].any(), "index points at a frozen leaf"


def _plan(rng, width, p_ins, universe):
    r = rng.random(width)
    codes = np.where(r < p_ins, OP_INSERT,
                     np.where(r < p_ins + 0.2, OP_DELETE,
                              OP_SEARCH)).astype(np.int32)
    keys = rng.integers(0, universe, width).astype(np.int32)
    return codes, keys, (keys % 1000 + 1).astype(np.int32)


def _both_apply(jdb, tdb, ref, plan):
    jr = jdb.apply(J.OpBatch(*plan))
    tr = tdb.apply(T.OpBatch(*plan))
    np.testing.assert_array_equal(np.asarray(jr.values), tr.values)
    np.testing.assert_array_equal(np.asarray(jr.timestamps), tr.timestamps)
    if ref is not None:
        want = ref.apply_batch([(int(c), int(k), int(v))
                                for c, k, v in zip(*plan)])
        np.testing.assert_array_equal(tr.values, want)


def test_grow_is_bit_exact():
    jdb, tdb = _pair(FIXED)
    ref = RefStore()
    rng = np.random.default_rng(0)
    for _ in range(4):
        _both_apply(jdb, tdb, ref, _plan(rng, 48, 0.6, 2000))
    st = tdb.store
    snap = int(st.ts) - 10
    probe = np.arange(0, 2000, 7, dtype=np.int32)
    before = TS.bulk_lookup(st, probe, snap)
    g = LC.grow(st, leaves=True, versions=True, tracker=True)
    jg = JLC.grow(jdb.store, leaves=True, versions=True, tracker=True)
    assert_same_store(jg, g, "grow")
    assert (g.cfg.max_leaves, g.cfg.max_versions, g.cfg.tracker_cap) == (
        2 * st.cfg.max_leaves, 2 * st.cfg.max_versions,
        2 * st.cfg.tracker_cap)
    ml = st.cfg.max_leaves
    for name in ("leaf_keys", "leaf_vhead", "leaf_count", "leaf_next",
                 "leaf_frozen", "leaf_ts"):
        assert np.array_equal(getattr(g, name).numpy()[:ml],
                              getattr(st, name).numpy()), name
    TS.check_invariants(g)
    assert TS.live_items(g) == ref.live_items()
    np.testing.assert_array_equal(TS.bulk_lookup(g, probe, snap).numpy(),
                                  before.numpy())
    assert LC.next_pool_size(48) == 64 and LC.next_pool_size(64) == 128
    # a deeper index: growing far past the depth model stacks root levels
    big = LC.grow(LC.grow(LC.grow(g, leaves=True), leaves=True),
                  leaves=True)
    jbig = JLC.grow(JLC.grow(JLC.grow(jg, leaves=True), leaves=True),
                    leaves=True)
    assert big.index.cfg.depth > st.index.cfg.depth
    assert_same_store(jbig, big, "grow x3")
    TS.check_invariants(big)


def test_maintain_reclaims_frozen_and_merges():
    pol = dict(auto_maintain=False)
    jdb, tdb = _pair(pol, max_leaves=1024, max_versions=1 << 13)
    ref = RefStore()
    rng = np.random.default_rng(1)
    keys = rng.choice(4000, 1500, replace=False).astype(np.int32)
    for i in range(0, len(keys), 96):
        k = keys[i:i + 96]
        _both_apply(jdb, tdb, ref, (np.full(len(k), OP_INSERT, np.int32), k,
                                    (k % 97 + 1).astype(np.int32)))
    acc0 = LC.leaf_accounting(tdb.store)
    assert acc0["dead"] > 0
    dels = np.sort(keys[keys < 3200])
    dels = dels[rng.random(len(dels)) < 0.8].astype(np.int32)
    for i in range(0, len(dels), 96):
        k = dels[i:i + 96]
        _both_apply(jdb, tdb, ref, (np.full(len(k), OP_DELETE, np.int32), k,
                                    np.zeros(len(k), np.int32)))
    n_leaves0 = int(tdb.store.n_leaves)
    total_rec = total_mer = 0
    for p in range(12):
        jr = jdb.maintain(48, phase=p)
        tr = tdb.maintain(48, phase=p)
        assert jr == tr
        total_rec += tr[0]
        total_mer += tr[1]
        _same(jdb, tdb, f"maintain pass {p}")
        TS.check_invariants(tdb.store)
        _assert_accounting(tdb.store)
    assert total_rec >= acc0["dead"] and total_mer > 0
    assert int(tdb.store.n_leaves) < n_leaves0
    assert tdb.live_items() == ref.live_items()
    assert tdb.stats["maintain_passes"] == 12
    assert tdb.stats["leaves_reclaimed"] == total_rec


def test_maintain_keeps_registered_snapshots_byte_stable():
    jdb, tdb = _pair(dict(auto_maintain=False))
    rng = np.random.default_rng(2)
    keys = rng.choice(5000, 800, replace=False).astype(np.int32)
    for db in (jdb, tdb):
        db.insert(keys, keys % 211 + 1)
    snap = tdb.acquire_snapshot()
    assert jdb.acquire_snapshot() == snap
    probe = np.arange(0, 5000, 3, dtype=np.int32)
    look0 = tdb.lookup(probe, snap)
    range0 = tdb.range(0, 4999, snap)
    for db in (jdb, tdb):
        db.delete(keys[::2])
        db.insert(keys[1::4] + 1, 7)
    for p in range(8):
        assert jdb.maintain(64, phase=p) == tdb.maintain(64, phase=p)
    for db in (jdb, tdb):
        db.grow(leaves=True, versions=True)
    _same(jdb, tdb, "after maintain + grow")
    np.testing.assert_array_equal(tdb.lookup(probe, snap), look0)
    assert tdb.range(0, 4999, snap) == range0
    for db in (jdb, tdb):
        db.release_snapshot(snap)
    lk0 = LC.live_key_count(tdb.store)
    want_live = tdb.live_items()
    now = tdb.ts
    for p in range(8):
        assert jdb.maintain(64, phase=p) == tdb.maintain(64, phase=p)
    _same(jdb, tdb, "after the release")
    assert LC.live_key_count(tdb.store) < lk0
    assert tdb.live_items() == want_live
    reinserted = set((keys[1::4] + 1).tolist())
    purged = np.array([k for k in keys[::2].tolist()
                       if k not in reinserted], np.int32)
    assert len(purged) and all(v == T.NOT_FOUND
                               for v in tdb.lookup(purged, now))


def test_self_sizing_schedule_matches_jax_bit_for_bit():
    """The default policy end to end: relieve_pressure on rejections,
    lifecycle_tick after every plan (maintain bursts and proactive
    growth), a held snapshot throughout — the same results, counters and
    arrays as the JAX client."""
    jdb, tdb = _pair()
    ref = RefStore()
    rng = np.random.default_rng(3)
    probe = np.arange(0, 400_000, 1013, dtype=np.int32)
    snap = expect = None
    for rnd in range(24):
        _both_apply(jdb, tdb, ref, _plan(rng, 128, 0.7, 400_000))
        if rnd == 8:
            snap = tdb.acquire_snapshot()
            assert jdb.acquire_snapshot() == snap
            expect = tdb.lookup(probe, snap)
            np.testing.assert_array_equal(jdb.lookup(probe, snap), expect)
    _same(jdb, tdb, "end of schedule")
    for key in ("grows", "maintain_passes", "leaves_reclaimed",
                "device_passes", "slow_path_rounds", "compactions"):
        assert jdb.stats[key] == tdb.stats[key], key
    assert tdb.stats["grows"] >= 2 and tdb.stats["maintain_passes"] > 0
    np.testing.assert_array_equal(tdb.lookup(probe, snap), expect)
    assert tdb.live_items() == ref.live_items()
    TS.check_invariants(tdb.store)
    _assert_accounting(tdb.store)
    # the delta-checkpoint watermarks read the same on both sides
    jw = JLC.pool_watermarks(jdb.store, compactions=2)
    tw = LC.pool_watermarks(tdb.store, compactions=2)
    assert dataclasses.asdict(jw) == dataclasses.asdict(tw)
    assert LC.leaf_accounting(tdb.store) == JLC.leaf_accounting(jdb.store)
    assert LC.live_key_count(tdb.store) == JLC.live_key_count(jdb.store)
    assert LC.dead_fraction(tdb.store) == JLC.dead_fraction(jdb.store)
    _both_apply(jdb, tdb, ref, _plan(rng, 128, 0.7, 400_000))
    for c in (2, 3):
        assert LC.version_tail_start(tw, tdb.store, compactions=c) == \
            JLC.version_tail_start(jw, jdb.store, compactions=c)
    assert LC.version_tail_start(tw, tdb.store, compactions=2) == tw.n_vers


def test_sustained_crud_grows_past_8x_with_oracle():
    """>8x the seed leaf pool through the port's client: no
    CapacityError, RefStore equivalence every plan, the accounting
    invariant, and a pinned snapshot across interleaved maintenance."""
    cfg = T.UruvConfig(**_cfg())
    db = T.Uruv(cfg, device="cpu")
    ref = RefStore()
    rng = np.random.default_rng(3)
    probe = np.arange(0, 400_000, 1013, dtype=np.int32)
    snap = snap_expect = None
    for rnd in range(70):
        plan = _plan(rng, 128, 0.7, 400_000)
        res = db.apply(T.OpBatch(*plan))
        want = ref.apply_batch([(int(c), int(k), int(v))
                                for c, k, v in zip(*plan)])
        np.testing.assert_array_equal(res.values, want)
        if rnd % 10 == 0:
            _assert_accounting(db.store)
        if rnd == 30:
            snap = db.acquire_snapshot()
            snap_expect = db.lookup(probe, snap)
    assert db.capacity.max_leaves >= 8 * cfg.max_leaves
    assert int(db.store.n_alloc) > 8 * cfg.max_leaves // 2
    assert db.stats["grows"] >= 3 and db.stats["leaves_reclaimed"] > 0
    np.testing.assert_array_equal(db.lookup(probe, snap), snap_expect)
    db.release_snapshot(snap)
    assert db.live_items() == ref.live_items()
    TS.check_invariants(db.store)
    _assert_accounting(db.store)
    with db.snapshot() as ts:
        assert db.range(0, 400_000, ts) == ref.range_query(0, 400_000,
                                                           ref.ts)


def test_held_snapshot_survives_tracker_churn_and_maintain():
    jdb, tdb = _pair(tracker_cap=8)
    keys = np.arange(100, dtype=np.int32)
    for db in (jdb, tdb):
        db.insert(keys, keys + 41)
    held = tdb.acquire_snapshot()
    assert jdb.acquire_snapshot() == held
    want = tdb.lookup(keys, held)
    assert int(want[0]) == 41
    for db in (jdb, tdb):
        for _ in range(3 * db.capacity.tracker_cap):
            with db.snapshot():
                pass
        db.delete(keys)
    for p in range(6):
        assert jdb.maintain(64, phase=p) == tdb.maintain(64, phase=p)
    assert tdb.active_snapshots == jdb.active_snapshots >= 1
    np.testing.assert_array_equal(tdb.lookup(keys, held), want)
    _same(jdb, tdb, "tracker churn")
    tdb.release_snapshot(held)


def test_tracker_grows_instead_of_dropping_registrations():
    jdb, tdb = _pair(tracker_cap=4)
    for db in (jdb, tdb):
        db.insert([1, 2, 3], [10, 20, 30])
    snaps = [tdb.acquire_snapshot() for _ in range(9)]
    assert [jdb.acquire_snapshot() for _ in range(9)] == snaps
    assert tdb.capacity.tracker_cap >= 9
    assert int(tdb.store.oflow) & TS.OFLOW_TRACKER == 0
    assert tdb.active_snapshots == 9
    _same(jdb, tdb, "tracker growth")
    for s in snaps:
        tdb.release_snapshot(s)
    assert tdb.active_snapshots == 0


def test_capacity_error_diagnostics_when_growth_disabled():
    tiny = dict(leaf_cap=4, max_leaves=8, max_versions=64, max_chain=8)
    keys = np.arange(0, 64, dtype=np.int32)
    errs = []
    for mod, db in ((J, J.Uruv(J.UruvConfig(**tiny), backend="xla",
                              policy=J.LifecyclePolicy(**FIXED))),
                    (T, T.Uruv(T.UruvConfig(**tiny), device="cpu",
                               policy=T.LifecyclePolicy(**FIXED)))):
        with pytest.raises(mod.CapacityError) as ei:
            for i in range(0, 64, 8):
                db.apply(mod.OpBatch.inserts(keys[i:i + 8], keys[i:i + 8]))
        errs.append(ei.value)
    je, te = errs
    assert te.oflow == je.oflow and te.oflow & (TS.OFLOW_LEAVES
                                                | TS.OFLOW_VERSIONS)
    assert te.occupancy == pytest.approx(je.occupancy) and te.occupancy > 0.5
    assert te.frozen_fraction == pytest.approx(je.frozen_fraction)
    assert te.max_versions == je.max_versions == 64
    assert "occupancy=" in str(te)
    db2 = T.Uruv(T.UruvConfig(**tiny), device="cpu")
    for i in range(0, 64, 8):
        db2.apply(T.OpBatch.inserts(keys[i:i + 8], keys[i:i + 8]))
    assert len(db2.live_items()) == 64
