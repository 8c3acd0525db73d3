"""The port's key-range-sharded store against the JAX package's, on the CPU.

The JAX side is the JAX package's own sharded code — ``make_apply``,
``make_routed_apply``, ``make_range_apply``, ``make_ops``, the
``Uruv.sharded`` client and its ``ShardedExecutor`` — run unchanged
through a ``jax.vmap`` stand-in for ``shard_map`` (``_torch_port.
emulate_jax_sharding``: jax 0.9's ``shard_map`` rejects the store's
``lax.cond`` over varying manual axes) on 4 shards of one CPU device.
The port's side is a stacked store of 4 shards on ``device="cpu"``.
Both take the same plans and must give bit-equal results, ``ok`` flags,
timestamps, range pages and resume frontiers, counters, and every
stacked store array; ``RefStore`` and the port's local ``Uruv`` are the
oracles.  Pools are small (``leaf_cap=16``, ``max_leaves=16``) and
widths fixed, so the JAX side compiles few shapes.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import api as J
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core import sharded as JSH
from repro.core.ref import (
    KEY_MAX, OP_DELETE, OP_INSERT, OP_SEARCH, RefStore,
)
from repro.serve.coalescer import (
    AdmissionPolicy as JAdmissionPolicy, Coalescer as JCoalescer,
)

import repro_torch.api as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import sharded as TSH
from repro_torch.core import store as TS
from repro_torch.launch import mesh as tmesh
from repro_torch.serve.coalescer import AdmissionPolicy, Coalescer

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    FakeMesh, assert_same_arrays, bounded_jax_maps, emulate_jax_sharding,
    fresh_jax_caches, jax_arrays, jax_stacked_store,
)

N = 4
KEY_HI = 1000
CFG = dict(leaf_cap=16, max_leaves=16, max_versions=1 << 10, tracker_cap=8,
           max_chain=16, index_fanout=4)


@pytest.fixture(autouse=True)
def jax_sharding(monkeypatch):
    emulate_jax_sharding(monkeypatch)


def _configs(**over):
    cfg = dict(CFG, **over)
    return (JSH.ShardedConfig(base=J.UruvConfig(**cfg), key_hi=KEY_HI),
            TSH.ShardedConfig(base=T.UruvConfig(**cfg), key_hi=KEY_HI))


def _stores(jcfg, tcfg):
    return (jax_stacked_store(jcfg.base, N),
            TSH.create(tcfg, tmesh.make_host_mesh(N, device="cpu")))


def _same(jstore, tstore, where):
    assert_same_arrays(jax_arrays(jstore), TS.to_numpy(tstore), where)


def _host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_outs(j, t, where):
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), _host(b), err_msg=where)


def _crud(rng, n, lo=0, hi=KEY_HI):
    r = rng.random(n)
    codes = np.where(r < 0.55, OP_INSERT,
                     np.where(r < 0.7, OP_DELETE, OP_SEARCH)).astype(np.int32)
    keys = rng.integers(lo, hi, n).astype(np.int32)
    vals = rng.integers(1, 10_000, n).astype(np.int32)
    return codes, keys, vals


def _ref_results(ref, codes, keys, vals):
    return np.asarray(ref.apply_batch(list(zip(
        codes.tolist(), keys.tolist(), vals.tolist()))))


def _pass(jf, tf, js, ts, plan, where):
    """One sharded pass on both sides from the same store: results, ok
    and every stacked array equal (a rejected pass's partial store too)."""
    jout = jf(js, *(jnp.asarray(x) for x in plan))
    tout = tf(ts, *plan)
    assert bool(jout[2]) == tout[2], where
    np.testing.assert_array_equal(np.asarray(jout[1]), _host(tout[1]),
                                  err_msg=where)
    _same(jout[0], tout[0], where)
    return bool(jout[2])


# ------------------------------------------------------------------ (a)
def test_apply_and_routed_apply_match_jax():
    jcfg, tcfg = _configs()
    jm, tm = FakeMesh(N), tmesh.make_host_mesh(N, device="cpu")
    js, ts = _stores(jcfg, tcfg)
    _same(js, ts, "create")
    fns = {"apply": (JSH.make_apply(jcfg, jm), TSH.make_apply(tcfg, tm)),
           "routed": (JSH.make_routed_apply(jcfg, jm, route_factor=3),
                      TSH.make_routed_apply(tcfg, tm, route_factor=3))}
    ref = RefStore()
    rng = np.random.default_rng(7)
    oks = []
    plans = [_crud(rng, 16) for _ in range(6)]
    # the forced fallback: every key on shard 0 overflows the routing
    # budget (4 ops of a source slice for one owner, cap 3)
    plans.append((np.full(16, OP_INSERT, np.int32),
                  np.arange(16, dtype=np.int32) * 7,
                  np.arange(1, 17, dtype=np.int32)))
    for p, plan in enumerate(plans):
        for name, (jf, tf) in fns.items():
            ok = _pass(jf, tf, js, ts, plan, f"plan {p} {name}")
            if name == "routed":
                oks.append(ok)
        jstats, tstats = {}, {}
        js, jres = JSH.sharded_apply_batch(
            js, *plan, apply_fn=fns["apply"][0], routed_fn=fns["routed"][0],
            stats=jstats)
        ts, tres = TSH.sharded_apply_batch(
            ts, *plan, apply_fn=fns["apply"][1], routed_fn=fns["routed"][1],
            stats=tstats)
        np.testing.assert_array_equal(np.asarray(jres), tres)
        np.testing.assert_array_equal(tres, _ref_results(ref, *plan))
        assert jstats == tstats, p
        _same(js, ts, f"plan {p} sequenced")
    assert not oks[-1] and jstats == {"device_passes": 2}
    assert any(oks), "the routed pass never succeeded"
    assert TSH.global_ts(ts) == 16 * len(plans)


# ------------------------------------------------------------------ (b)
def test_range_apply_matches_jax_with_truncation():
    jcfg, tcfg = _configs()
    jm, tm = FakeMesh(N), tmesh.make_host_mesh(N, device="cpu")
    js, ts = _stores(jcfg, tcfg)
    japp, tapp = JSH.make_apply(jcfg, jm), TSH.make_apply(tcfg, tm)
    rng = np.random.default_rng(11)
    ref = RefStore()
    for p in range(8):
        plan = _crud(rng, 16)
        plan = (np.where(plan[0] == OP_DELETE, OP_INSERT, plan[0])
                .astype(np.int32),) + plan[1:]
        js, _ = JSH.sharded_apply_batch(js, *plan, apply_fn=japp)
        ts, _ = TSH.sharded_apply_batch(ts, *plan, apply_fn=tapp)
        _ref_results(ref, *plan)
    _same(js, ts, "prefill")
    # small budgets: max_results overflow and per-shard leaf truncation
    # (the frontier clamp) both occur
    opts = dict(max_results=8, scan_leaves=1, max_rounds=1)
    jr = JSH.make_range_apply(jcfg, jm, **opts)
    tr = TSH.make_range_apply(tcfg, tm, **opts)
    k1 = np.array([0, 100, 240, 260, 490, 700, 999, 5], np.int32)
    k2 = np.array([999, 160, 270, 255, 760, 990, 999, 30], np.int32)
    snap = np.full(8, TSH.global_ts(ts), np.int32)
    seen = [[] for _ in k1]
    lo = k1.copy()
    for rnd in range(40):
        jout = jr(js, jnp.asarray(lo), jnp.asarray(k2), jnp.asarray(snap))
        tout = tr(ts, lo, k2, snap)
        _same_outs(jout, tout, f"round {rnd}")
        keys, vals, cnt, trunc, resume = (_host(x) for x in tout)
        if rnd == 0:
            assert trunc.any() and (cnt == 8).any()
        for q in range(len(k1)):
            seen[q].extend(zip(keys[q, :cnt[q]].tolist(),
                               vals[q, :cnt[q]].tolist()))
        if not trunc.any():
            break
        lo = np.where(trunc, resume, KEY_MAX).astype(np.int32)
    assert not trunc.any()
    want = ref.live_items()
    for q in range(len(k1)):
        assert seen[q] == [kv for kv in want if k1[q] <= kv[0] <= k2[q]]


# ------------------------------------------------------------------ (c)
def test_make_ops_match_jax():
    jcfg, tcfg = _configs()
    jm, tm = FakeMesh(N), tmesh.make_host_mesh(N, device="cpu")
    js, ts = _stores(jcfg, tcfg)
    jupd, jlkp, jrq = JSH.make_ops(jcfg, jm)
    tupd, tlkp, trq = TSH.make_ops(tcfg, tm)
    rng = np.random.default_rng(3)
    ref = RefStore()
    for p in range(5):
        keys = rng.integers(0, KEY_HI, 16).astype(np.int32)
        vals = rng.integers(1, 500, 16).astype(np.int32)
        vals[rng.random(16) < 0.2] = T.TOMBSTONE
        keys[-1] = KEY_MAX                     # a padded (NOP) op
        jout = jupd(js, jnp.asarray(keys), jnp.asarray(vals))
        tout = tupd(ts, keys, vals)
        assert bool(jout[2]) and tout[2]
        np.testing.assert_array_equal(np.asarray(jout[1]), _host(tout[1]))
        js, ts = jout[0], tout[0]
        _same(js, ts, f"update {p}")
        codes = TS.derive_update_codes(keys, vals)
        np.testing.assert_array_equal(_host(tout[1]),
                                      _ref_results(ref, codes, keys, vals))
    now = TSH.global_ts(ts)
    probe = np.concatenate([rng.integers(0, KEY_HI, 15),
                            [KEY_MAX]]).astype(np.int32)
    for snap in (now, now - 40):
        np.testing.assert_array_equal(
            np.asarray(jlkp(js, jnp.asarray(probe), jnp.int32(snap))),
            _host(tlkp(ts, probe, snap)))
    for k1, k2 in ((0, 999), (240, 260), (10, 5)):
        jo = jrq(js, k1, k2, now, max_scan_leaves=2, max_results=8)
        to = trq(ts, k1, k2, now, max_scan_leaves=2, max_results=8)
        _same_outs(jo, to, f"range_q {k1}..{k2}")
        assert JSH.merge_range_results(*jo[:3]) == \
            TSH.merge_range_results(*to[:3])


# ------------------------------------------------------------------ (d)
def _plans(rng, n_plans):
    """Plans of one layout (16 CRUD, 2 RANGE, 12 CRUD): both CRUD
    segments divide the shard count, so the routed pass runs."""
    for _ in range(n_plans):
        a, b = _crud(rng, 16), _crud(rng, 12)
        lo = rng.integers(0, KEY_HI, 2).astype(np.int32)
        yield a, (lo, (lo + rng.integers(-5, 300, 2)).astype(np.int32)), b


def _build(api, plan):
    a, (lo, hi), b = plan
    return api.OpBatch.concat(api.OpBatch(*a), api.OpBatch.ranges(lo, hi),
                              api.OpBatch(*b))


def _same_result(j, t, where):
    for f in ("values", "found", "timestamps", "range_index",
              "range_resume"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f), err_msg=f"{where} {f}")
    assert j.pages() == t.pages(), where


def _same_page(jp, tp, where):
    for f in ("keys", "values", "count", "truncated", "resume_k1"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(),
                                      err_msg=f"{where} {f}")


POLICY = dict(min_dead_leaves=4)


def _clients(**over):
    jcfg, tcfg = _configs(**over)
    jdb = J.Uruv.sharded(jcfg, FakeMesh(N),
                         store=jax_stacked_store(jcfg.base, N),
                         policy=J.LifecyclePolicy(**POLICY))
    tdb = T.Uruv.sharded(tcfg, tmesh.make_host_mesh(N, device="cpu"),
                         policy=T.LifecyclePolicy(**POLICY))
    return jdb, tdb


def test_sharded_client_matches_jax_local_and_refstore():
    jdb, tdb = _clients(max_leaves=4)      # grows past 4 leaves a shard
    local = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    ref = RefStore()
    rng = np.random.default_rng(42)
    held = None
    for p, plan in enumerate(_plans(rng, 10)):
        if p == 5:
            held = (tdb.acquire_snapshot(), jdb.acquire_snapshot(),
                    local.acquire_snapshot())
            assert held[0] == held[1] == held[2]
        jr = jdb.apply(_build(J, plan))
        tr = tdb.apply(_build(T, plan))
        lr = local.apply(_build(T, plan))
        _same_result(jr, tr, f"plan {p} jax")
        _same_result(lr, tr, f"plan {p} local")
        a, (lo, hi), b = plan
        ops = (list(zip(*(x.tolist() for x in a)))
               + [(T.OP_RANGE, int(x), int(y)) for x, y in zip(lo, hi)]
               + list(zip(*(x.tolist() for x in b))))
        want = ref.apply_batch(ops)
        np.testing.assert_array_equal(tr.values, want)
        assert jdb.ts == tdb.ts == local.ts
        _same(jdb.store, tdb.store, f"plan {p}")
    stats = tdb.stats
    assert stats == jdb.stats
    assert stats["grows"] > 0 and stats["maintain_passes"] > 0
    assert tdb.capacity.max_leaves > 4
    snap = held[0]
    k1 = np.array([0, 300, 600, 999], np.int32)
    k2 = np.array([350, 650, 998, 999], np.int32)
    assert tdb.range_all(k1, k2, snap) == jdb.range_all(k1, k2, snap) \
        == local.range_all(k1, k2, snap)
    _same_page(jdb.range_page(k1, k2, snap, max_results=4, scan_leaves=1,
                              max_rounds=1),
               tdb.range_page(k1, k2, snap, max_results=4, scan_leaves=1,
                              max_rounds=1), "range_page")
    probe = rng.integers(0, KEY_HI, 16).astype(np.int32)
    for s in (snap, None):
        got = tdb.lookup(probe, s)
        np.testing.assert_array_equal(got, np.asarray(jdb.lookup(probe, s)))
        np.testing.assert_array_equal(got, local.lookup(probe, s))
    for db in (tdb, jdb, local):
        db.release_snapshot(snap)
    assert tdb.active_snapshots == jdb.active_snapshots == 0
    assert tdb.live_items() == jdb.live_items() == local.live_items() \
        == ref.live_items()
    for st in TS.shard_views(tdb.store):
        TS.check_invariants(st)
    _same(jdb.store, tdb.store, "end")
    assert "ShardedExecutor" in repr(tdb)


# ------------------------------------------------------------------ (e)
def test_snapshot_release_compact_reindex_match_jax():
    jdb, tdb = _clients(max_leaves=32)
    rng = np.random.default_rng(5)
    keys = rng.choice(KEY_HI, 48, replace=False).astype(np.int32)
    for db, api in ((jdb, J), (tdb, T)):
        db.apply(api.OpBatch.inserts(keys[:16], keys[:16] + 1))
        db.apply(api.OpBatch.inserts(keys[16:32], keys[16:32] + 1))
    _same(jdb.store, tdb.store, "prefill")
    snaps = []
    for db, api in ((jdb, J), (tdb, T)):
        s = db.acquire_snapshot()
        db.apply(api.OpBatch.deletes(keys[:16]))
        snaps.append(s)
    assert snaps[0] == snaps[1]
    _same(jdb.store, tdb.store, "snapshot + deletes")
    assert jdb.compact() == tdb.compact()       # held: versions stay
    _same(jdb.store, tdb.store, "compact under a snapshot")
    for db in (jdb, tdb):
        db.release_snapshot(snaps[0])
    _same(jdb.store, tdb.store, "release")
    assert jdb.compact() == tdb.compact() == 16
    _same(jdb.store, tdb.store, "compact")
    jdb.reindex()
    tdb.reindex()
    _same(jdb.store, tdb.store, "reindex")
    assert jdb.stats == tdb.stats
    assert tdb.live_items() == [(int(k), int(k) + 1)
                                for k in np.sort(keys[16:32])]


# ------------------------------------------------------------------ (f)
def test_stacked_checkpoints_cross_between_packages(tmp_path):
    tcfg = _configs()[1]
    tdb = T.Uruv.sharded(tcfg, tmesh.make_host_mesh(N, device="cpu"))
    rng = np.random.default_rng(9)
    for _ in range(3):
        tdb.apply(T.OpBatch(*_crud(rng, 16)))
    mgr = CheckpointManager(tmp_path / "port", async_write=False,
                            device="cpu")
    mgr.save_store(tdb.store, 1)
    for _ in range(2):
        tdb.apply(T.OpBatch(*_crud(rng, 16)))
    mgr.save_store_delta(tdb.store, 2)
    jmgr = JCheckpointManager(str(tmp_path / "port"), async_write=False)
    for step in (1, 2):
        jstore, got = jmgr.restore_store(step)
        assert got == step and jmgr.store_ts(step) == mgr.store_ts(step)
        want = TS.to_numpy(tdb.store) if step == 2 else None
        if want is not None:
            assert_same_arrays(jax_arrays(jstore), want, "port -> JAX")
    # the reverse: the JAX package writes the stacked store, the port reads
    jmgr2 = JCheckpointManager(str(tmp_path / "jax"), async_write=False)
    jmgr2.save_store(jstore, 7)
    tmgr2 = CheckpointManager(tmp_path / "jax", async_write=False,
                              device="cpu")
    tstore, step = tmgr2.restore_store()
    assert step == 7 and TS.is_stacked(tstore)
    assert_same_arrays(jax_arrays(jstore), TS.to_numpy(tstore), "JAX -> port")
    again = T.Uruv.sharded(tcfg, tmesh.make_host_mesh(N, device="cpu"),
                           store=tstore)
    assert again.live_items() == tdb.live_items() and again.ts == tdb.ts


# ------------------------------------------------------------------ (g)
def test_coalescer_over_sharded_client_degrades_like_jax():
    jdb, tdb = _clients(max_leaves=64)
    rng = np.random.default_rng(13)
    pol = dict(start_width=16, min_width=16, max_width=16,
               base_deadline_s=1e9)
    jc = JCoalescer(jdb, JAdmissionPolicy(**pol))
    tc = Coalescer(tdb, AdmissionPolicy(**pol))
    futs = []
    for wave in range(5):
        reqs = [_crud(rng, 4) for _ in range(4)]
        futs.append([(jc.submit(J.OpBatch(*r)), tc.submit(T.OpBatch(*r)))
                     for r in reqs])
        jc.pump(force=True)
        tc.pump(force=True)
    lo = rng.integers(0, KEY_HI - 200, 4).astype(np.int32)
    futs.append([(jc.submit(J.OpBatch.ranges(lo, lo + 200)),
                  tc.submit(T.OpBatch.ranges(lo, lo + 200)))])
    jc.flush()
    tc.flush()
    for wave in futs:
        for jf, tf in wave:
            _same_result(jf.result(), tf.result(), "future")
    assert tc.stats == jc.stats
    assert tc.stats["plans_sync"] == tc.stats["plans"] == 6
    assert tdb.stats == jdb.stats
    _same(jdb.store, tdb.store, "coalesced")


# ------------------------------------------------------------ devices
def test_sharded_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_host_mesh(N)
    mesh = tmesh.make_host_mesh(N, device="cpu")
    assert mesh.shape["data"] == N and mesh.device.type == "cpu"
    tcfg = _configs()[1]
    db = T.Uruv.sharded(tcfg, mesh)
    assert db.store.ts.shape == (N,) and db.store.leaf_keys.device.type \
        == "cpu"
    assert isinstance(db.executor, T.ShardedExecutor)
    with pytest.raises(NotImplementedError):
        db.apply_nowait(T.OpBatch.inserts([1], [2]))
    plan = _crud(np.random.default_rng(1), 14)
    for a, b in zip(JSH.pad_announce(*plan, N), TSH.pad_announce(*plan, N)):
        np.testing.assert_array_equal(a, b)
        assert len(b) == 16
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSH.create(tcfg, tmesh.Mesh({"data": N, "model": 1},
                                    ("data", "model"), torch.device("cuda")))
