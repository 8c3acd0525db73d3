"""The port's durability path against the JAX package's, on the CPU.

  * the WAL: the same seeded plan stream through the JAX ``Wal`` and the
    port's gives byte-identical segment files, and each package opens the
    other's log;
  * the torn-record corpus of ``tests/test_wal_recovery.py`` against the
    port: truncated tails, bit flips in the final and a non-final segment,
    duplicate records, a duplicated segment file, a headerless final
    segment, a ``.tmp_step_*`` leak, a delta chain with a missing base and
    GC that keeps chain bases;
  * cross-package recovery, both ways: a JAX durable directory (full and
    delta checkpoints and a WAL tail) recovers in the port bit for bit,
    and a port directory recovers in the JAX package; a pipelined
    coalescer run writes the same WAL in both packages; the port's own
    round trip across ``grow`` holds against the port's live store (the
    JAX restore after growth is not ground truth: its
    ``test_checkpoint_roundtrip_across_grow`` fails on this tree);
  * the kill -9 battery of ``tests/test_wal_recovery.py`` on the port
    (``device="cpu"``), with workers that import ``repro_torch`` and no JAX:
    the recovered prefix covers every acknowledged plan and equals the
    RefStore replay of exactly that prefix, version timestamps included.
"""

import os
import shutil
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import _wal_workload as W
from repro import api as J
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.durability import Wal as JWal
from repro.serve.coalescer import (
    AdmissionPolicy as JAdmissionPolicy, Coalescer as JCoalescer,
)

import repro_torch.api as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.store import to_numpy
from repro_torch.distributed import fault as T_fault
from repro_torch.durability import (
    Wal, WalCorruptionError, WalReplayError, recover,
)
from repro_torch.durability.recovery import replay
from repro_torch.durability.wal import PAY_HEADER, REC_HEADER
from repro_torch.serve.coalescer import AdmissionPolicy, Coalescer

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    assert_same_arrays, assert_same_store, fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

ROOT = Path(__file__).resolve().parents[1]

# big enough that no JAX-as-truth case grows a pool (and no lifecycle:
# the pairs below run the fixed footprint on both sides)
CFG = dict(leaf_cap=8, max_leaves=256, max_versions=1 << 13, tracker_cap=16,
           max_chain=16)
J_FIXED = J.LifecyclePolicy(auto_grow=False, auto_maintain=False)


def _small():
    """The battery's small config (it crosses grow() boundaries)."""
    return T.UruvConfig(leaf_cap=8, max_leaves=16, max_versions=128,
                        tracker_cap=8)


def _policy(maintain: bool):
    return T.LifecyclePolicy(auto_grow=True, auto_maintain=maintain,
                             version_gc_fraction=2.0)


def _plans(seed, n_plans, width):
    """CRUD + RANGE plans (read ops log too: replay turns them to NOPs)."""
    return W.make_plans(seed, n_plans, width, "update")


def _fig9b_shape(plans):
    """Each plan's RANGE ops moved behind its CRUD ops, as in the paper's
    fig9b plans.  Recovery replays read ops as NOPs in one pass; a live
    plan with RANGE ops between CRUD ops runs as several passes, which
    place version slots differently (the same results, other arrays) —
    in the JAX package as in the port.  With the RANGE ops at the tail
    the recovered store is bit-equal to the live one."""
    out = []
    for p in plans:
        o = np.argsort(p.codes == T.OP_RANGE, kind="stable")
        out.append(J.OpBatch(p.codes[o], p.keys[o], p.values[o]))
    return out


def _files(directory):
    return {p.name: p.read_bytes()
            for p in sorted(Path(directory).glob("wal_*.log"))}


# ---------------------------------------------------------------------------
# fault injection: the same selector as the reference
# ---------------------------------------------------------------------------

def test_crash_point_selector_matches_reference(monkeypatch):
    from repro.distributed import fault as J_fault

    assert T_fault.CRASH_POINT_ENV == J_fault.CRASH_POINT_ENV
    monkeypatch.setenv(T_fault.CRASH_POINT_ENV, "wal.pre_fsync:3")
    T_fault.reset_crash_counters()
    T_fault.crash_point("wal.post_fsync")        # another name: no count
    T_fault.crash_point("wal.pre_fsync")
    T_fault.crash_point("wal.pre_fsync")         # 2 of 3: still alive
    assert T_fault._crash_hits == {"wal.pre_fsync": 2}
    T_fault.reset_crash_counters()
    assert T_fault._crash_hits == {}


# ---------------------------------------------------------------------------
# WAL bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("segment_bytes,group_commit", [(4 << 20, 1),
                                                        (700, 3)])
def test_wal_segments_byte_identical(tmp_path, segment_bytes, group_commit):
    """The same seeded plan stream through both packages' WAL writers:
    the same segment files, byte for byte; each opens the other's log."""
    plans = _plans(5, 14, 24)
    for name, cls in (("jax", JWal), ("port", Wal)):
        wal = cls.open(tmp_path / name, segment_bytes=segment_bytes,
                       group_commit=group_commit)
        ts = 0
        for p in plans:
            wal.append(ts, p.codes, p.keys, p.values)
            wal.commit(force=False)
            ts += len(p)
        wal.close()
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(a) >= (2 if segment_bytes < 1000 else 1)
    assert a == b
    for other, cls in (("jax", Wal), ("port", JWal)):
        recs = cls.open(tmp_path / other).records()
        assert [(r.base_ts, r.next_ts) for r in recs] == \
            [(24 * i, 24 * i + 24) for i in range(14)]
        for r, p in zip(recs, plans):
            np.testing.assert_array_equal(r.keys, p.keys)


# ---------------------------------------------------------------------------
# torn-record corpus (Wal-level, no subprocesses) — the port's WAL
# ---------------------------------------------------------------------------

def _write_wal(directory, n_records=6, width=4, base=0):
    wal = Wal.open(directory)
    for i in range(n_records):
        wal.append(base + i * width, np.zeros(width, np.int32),
                   np.arange(width, dtype=np.int32) + i,
                   np.full(width, i + 1, np.int32))
        wal.commit()
    wal.close()
    return sorted(Path(directory).glob("wal_*.log"))


@pytest.mark.parametrize("cut", [1, 44, 72, 100])
def test_torn_tail_truncated_and_reported(tmp_path, cut):
    [seg] = _write_wal(tmp_path / "wal")
    size = seg.stat().st_size
    with open(seg, "r+b") as f:
        f.truncate(size - cut)
    wal = Wal.open(tmp_path / "wal")
    rec_bytes = REC_HEADER.size + PAY_HEADER.size + 12 * 4
    hdr = 16                                        # segment header bytes
    survive = (size - cut - hdr) // rec_bytes       # whole records left
    assert wal.report.n_records == survive
    assert wal.report.torn_tail == ((size - cut - hdr) % rec_bytes != 0)
    assert wal.report.truncated_bytes == (size - cut - hdr) % rec_bytes
    wal.close()
    wal2 = Wal.open(tmp_path / "wal")
    assert not wal2.report.torn_tail
    assert wal2.report.n_records == survive
    wal2.close()


def test_bitflip_in_final_segment_truncates_from_there(tmp_path):
    [seg] = _write_wal(tmp_path / "wal")
    data = bytearray(seg.read_bytes())
    rec_bytes = REC_HEADER.size + PAY_HEADER.size + 12 * 4
    flip_at = 16 + 2 * rec_bytes + REC_HEADER.size + 3   # record 3 payload
    data[flip_at] ^= 0x40
    seg.write_bytes(bytes(data))
    wal = Wal.open(tmp_path / "wal")
    assert wal.report.n_records == 2                     # records 1-2 only
    assert wal.report.torn_tail
    assert wal.report.truncated_bytes == 4 * rec_bytes
    wal.close()


def _rotated_wal(directory):
    wal = Wal.open(directory, segment_bytes=128)
    for i in range(8):
        wal.append(i * 4, np.zeros(4, np.int32),
                   np.arange(4, dtype=np.int32), np.full(4, i, np.int32))
        wal.commit()
    wal.close()
    return sorted(Path(directory).glob("wal_*.log"))


def test_bitflip_in_nonfinal_segment_is_rejected(tmp_path):
    segs = _rotated_wal(tmp_path / "wal")
    assert len(segs) >= 2
    data = bytearray(segs[0].read_bytes())
    data[-5] ^= 0x01                                     # corrupt EARLIER seg
    segs[0].write_bytes(bytes(data))
    with pytest.raises(WalCorruptionError):
        Wal.open(tmp_path / "wal")


def test_duplicate_records_skip_on_replay(tmp_path):
    """A duplicate plan record parses fine and is skipped by the
    ``next_ts <= clock`` rule; a gap is rejected."""
    wal = Wal.open(tmp_path / "wal")
    for base, k, v in ((0, [1, 2], [10, 20]), (0, [1, 2], [10, 20]),
                       (2, [3, 4], [30, 40])):
        wal.append(base, np.full(2, 0, np.int32), np.array(k, np.int32),
                   np.array(v, np.int32))
    wal.commit()
    db = T.Uruv(_small(), device="cpu")
    assert replay(db, wal.records()) == 2                 # dup skipped
    assert db.ts == 4
    assert db.lookup([1, 2, 3, 4], db.ts).tolist() == [10, 20, 30, 40]
    wal.append(99, np.full(2, 0, np.int32), np.array([5, 6], np.int32),
               np.array([50, 60], np.int32))              # gap: base 99 != 4
    with pytest.raises(WalReplayError):
        replay(db, wal.records())
    wal.close()


def test_duplicated_segment_file_is_rejected(tmp_path):
    segs = _rotated_wal(tmp_path / "wal")
    assert len(segs) >= 3
    shutil.copy(segs[0], segs[1])            # seq 1 contents under seq 2 name
    with pytest.raises(WalCorruptionError):
        Wal.open(tmp_path / "wal")


def test_headerless_final_segment_is_unlinked(tmp_path):
    [seg] = _write_wal(tmp_path / "wal")
    nxt = seg.parent / "wal_00000002.log"
    nxt.write_bytes(b"URUV")                 # died inside _open_segment
    wal = Wal.open(tmp_path / "wal")
    assert not nxt.exists()
    assert wal.report.n_records == 6
    wal.append(24, np.zeros(4, np.int32), np.zeros(4, np.int32),
               np.zeros(4, np.int32))        # writer still appends cleanly
    wal.commit()
    wal.close()
    assert Wal.open(tmp_path / "wal").report.n_records == 7


def test_tmp_step_leak_cleaned_on_open(tmp_path):
    torn = tmp_path / ".tmp_step_00000005"
    torn.mkdir()
    (torn / ".ts.npy").write_bytes(b"half a leaf")
    mgr = CheckpointManager(tmp_path, async_write=False, device="cpu")
    assert not torn.exists()
    assert mgr.latest_step() is None         # junk never became a step
    db = T.Uruv(_small(), device="cpu")
    db.insert([1], [10])
    mgr.save_store(db.store, 1)
    assert mgr.latest_step() == 1            # normal saves still publish


def test_delta_chain_missing_base_is_not_complete(tmp_path):
    db = T.Uruv(_small(), device="cpu")
    db.insert([1, 2], [10, 20])
    mgr = CheckpointManager(tmp_path, keep=5, async_write=False,
                            device="cpu")
    mgr.save_store(db.store, 2)
    db.insert([3], [30])
    mgr.save_store_delta(db.store, 3)
    shutil.rmtree(tmp_path / "step_00000002")     # break the chain
    mgr2 = CheckpointManager(tmp_path, keep=5, async_write=False,
                             device="cpu")
    assert mgr2.latest_step() is None


def test_delta_gc_keeps_chain_bases(tmp_path):
    db = T.Uruv(_small(), device="cpu")
    db.insert([1], [10])
    mgr = CheckpointManager(tmp_path, keep=1, async_write=False,
                            device="cpu")
    mgr.save_store(db.store, 1)
    for s in (2, 3):
        db.insert([s * 10], [s])
        mgr.save_store_delta(db.store, s)
    assert sorted(int(p.name.split("_")[1])
                  for p in tmp_path.glob("step_*")) == [1, 2, 3]
    store, step = mgr.restore_store()
    assert step == 3
    assert T.Uruv.from_store(store).live_items() == db.live_items()
    assert_same_arrays(to_numpy(store), to_numpy(db.store), "gc chain")


def test_async_save_then_wait_restores(tmp_path):
    """The default writer runs on a thread; ``wait`` joins it, and the
    published step restores bit for bit."""
    db = T.Uruv(_small(), device="cpu")
    db.insert(np.arange(30, dtype=np.int32), np.arange(30, dtype=np.int32))
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save_store(db.store, int(db.ts))
    db.delete(np.arange(0, 30, 3, dtype=np.int32))
    mgr.save_store_delta(db.store, int(db.ts))
    mgr.wait()
    assert mgr.latest_step() == db.ts and mgr.store_ts() == db.ts
    store, _ = mgr.restore_store()
    assert_same_arrays(to_numpy(store), to_numpy(db.store), "async")


# ---------------------------------------------------------------------------
# the on-disk checkpoint format
# ---------------------------------------------------------------------------

def test_checkpoint_files_and_manifest_match_reference(tmp_path):
    """A port save and a JAX save of the same store: the same file names,
    the same manifest entries (names, order, modes, shapes, dtypes) and
    the same arrays; each manager restores the other's step."""
    jdb = J.Uruv(J.UruvConfig(**CFG), backend="xla", policy=J_FIXED)
    tdb = T.Uruv(T.UruvConfig(**CFG), device="cpu", policy=T.FIXED_FOOTPRINT)
    for p in _plans(2, 3, 32):
        jdb.apply(p)
        tdb.apply(p)
    assert_same_store(jdb.store, tdb.store, "before the save")
    JCheckpointManager(tmp_path / "jax", async_write=False).save_store(
        jdb.store, 96)
    CheckpointManager(tmp_path / "port", async_write=False,
                      device="cpu").save_store(tdb.store, 96)
    jd, td = tmp_path / "jax" / "step_00000096", \
        tmp_path / "port" / "step_00000096"
    assert sorted(p.name for p in jd.iterdir()) == \
        sorted(p.name for p in td.iterdir())
    assert ".index__.node_keys__0.npy" in {p.name for p in td.iterdir()}
    import json

    assert json.loads((jd / "manifest.json").read_text()) == \
        json.loads((td / "manifest.json").read_text())
    for f in jd.glob("*.npy"):
        a, b = np.load(f), np.load(td / f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    store, _ = CheckpointManager(tmp_path / "jax", async_write=False,
                                 device="cpu").restore_store()
    assert_same_store(jdb.store, store, "port restores a JAX step")
    jstore, _ = JCheckpointManager(tmp_path / "port",
                                   async_write=False).restore_store()
    assert_same_store(jstore, tdb.store, "JAX restores a port step")


# ---------------------------------------------------------------------------
# cross-package recovery
# ---------------------------------------------------------------------------

def _drive_durable(db, plans, *, ckpt_at=(3, 6)):
    """Apply ``plans``; a snapshot registered after plan 2 (it takes one
    clock tick, inside the first checkpoint), a full checkpoint after plan
    ckpt_at[0], a delta after ckpt_at[1], the WAL tail after; returns the
    held snapshot."""
    held = None
    for i, p in enumerate(plans, 1):
        db.apply(p)
        if i == 2:
            held = db.acquire_snapshot()
        if i == ckpt_at[0]:
            db.checkpoint(delta=False)
        elif i == ckpt_at[1]:
            db.checkpoint()
    db.sync_durable()
    return held


def test_jax_durable_dir_recovers_in_port(tmp_path):
    plans = _fig9b_shape(_plans(9, 10, 32))
    jdb = J.Uruv(J.UruvConfig(**CFG), backend="xla", policy=J_FIXED,
                 durable_dir=tmp_path, group_commit=2)
    held = _drive_durable(jdb, plans)
    steps = sorted(p.name for p in (tmp_path / "ckpt").glob("step_*"))
    assert steps == ["step_00000097", "step_00000193"]
    db = recover(tmp_path, device="cpu", policy=T.FIXED_FOOTPRINT)
    assert db.ts == jdb.ts
    assert db.recovery.checkpoint_step == 193
    assert db.recovery.replayed_plans == 4
    assert_same_store(jdb.store, db.store, "JAX dir -> port recover")
    assert db.range(0, W.KEYSPACE, held) == jdb.range(0, W.KEYSPACE, held)
    # the recovered port client keeps logging into the JAX directory
    extra = _fig9b_shape(_plans(10, 1, 32))[0]
    db.apply(extra)
    jdb.apply(extra)
    db.durability.close()
    jdb.durability.close()
    again = J.Uruv.recover(tmp_path, backend="xla", policy=J_FIXED)
    assert_same_store(again.store, db.store, "port-extended JAX dir")
    again.durability.close()


def test_port_durable_dir_recovers_in_jax(tmp_path):
    plans = _fig9b_shape(_plans(4, 10, 32))
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu",
                policy=T.FIXED_FOOTPRINT, durable_dir=tmp_path,
                group_commit=3)
    held = _drive_durable(db, plans)
    jdb = J.Uruv.recover(tmp_path, backend="xla", policy=J_FIXED)
    assert jdb.ts == db.ts
    assert jdb.recovery.checkpoint_step == 193
    assert jdb.recovery.replayed_plans == 4
    assert_same_store(jdb.store, db.store, "port dir -> JAX recover")
    assert jdb.range(0, W.KEYSPACE, held) == db.range(0, W.KEYSPACE, held)
    jdb.durability.close()
    db.durability.close()


def test_interleaved_ranges_recover_alike_in_both_packages(tmp_path):
    """Plans with RANGE ops between CRUD ops: the port and the JAX package
    recover the same directory to bit-equal stores, and both give the
    live run's results (values and version timestamps, at sampled past
    snapshots too)."""
    plans = _plans(6, 10, 32)
    jdb = J.Uruv(J.UruvConfig(**CFG), backend="xla", policy=J_FIXED,
                 durable_dir=tmp_path)
    for i, p in enumerate(plans, 1):
        jdb.apply(p)
        if i in (3, 6):
            jdb.checkpoint()
    jdb.sync_durable()
    db = recover(tmp_path, device="cpu", policy=T.FIXED_FOOTPRINT)
    db.durability.close()
    jback = J.Uruv.recover(tmp_path, backend="xla", policy=J_FIXED)
    assert_same_store(jback.store, db.store, "JAX recover == port recover")
    assert W.summarize(db) == W.summarize(jdb) == W.ref_summary(plans, 10)
    jback.durability.close()
    jdb.durability.close()


def test_coalescer_writes_the_same_wal_in_both_packages(tmp_path):
    """Pipelined coalescer runs with the same deterministic schedule over
    a JAX and a port durable client: byte-identical WALs (one record per
    base_ts, rejected plans logged once, by their replay), equal stores,
    and each directory recovers to the other's store."""
    cfg = dict(CFG, max_leaves=64, max_versions=1 << 10)
    rng = np.random.default_rng(23)
    schedule = []
    for wave in range(10):
        reqs = []
        for _ in range(int(rng.integers(2, 8))):
            k = rng.integers(1, 3000, int(rng.integers(1, 6))).astype(np.int32)
            if rng.random() < 0.7:
                reqs.append(("ins", k, k % 97 + 1))
            else:
                reqs.append(("get", k, None))
        schedule.append(reqs)
    schedule[3].append(("ins", np.arange(5000, 5064, dtype=np.int32),
                        np.full(64, 7, np.int32)))   # a burst into one leaf
    stores = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        if name == "jax":
            mod = J
            db = J.Uruv(J.UruvConfig(**cfg), backend="xla", policy=J_FIXED,
                        durable_dir=d, group_commit=4)
            c = JCoalescer(db, JAdmissionPolicy(start_width=32, max_width=64,
                                                base_deadline_s=1e9))
        else:
            mod = T
            db = T.Uruv(T.UruvConfig(**cfg), device="cpu",
                        policy=T.FIXED_FOOTPRINT, durable_dir=d,
                        group_commit=4)
            c = Coalescer(db, AdmissionPolicy(start_width=32, max_width=64,
                                              base_deadline_s=1e9))
        futs = []
        for wave, reqs in enumerate(schedule):
            for kind, k, v in reqs:
                plan = mod.OpBatch.inserts(k, v) if kind == "ins" \
                    else mod.OpBatch.searches(k)
                futs.append(c.submit(plan))
            c.pump(force=wave % 2 == 0, now=0.0)
        c.flush()
        assert all(f.done for f in futs)
        stores[name] = (db, c.stats, [f.result().values for f in futs])
    (jdb, jst, jv), (tdb, tst, tv) = stores["jax"], stores["port"]
    assert jst == tst and jst["plans_rejected"] >= 1
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(a, b)
    assert_same_store(jdb.store, tdb.store, "coalesced stores")
    assert _files(tmp_path / "jax" / "wal") == \
        _files(tmp_path / "port" / "wal")
    assert len(Wal.open(tmp_path / "port" / "wal").records()) == \
        jst["plans"]
    jdb.durability.close()
    tdb.durability.close()
    back = recover(tmp_path / "jax", device="cpu", policy=T.FIXED_FOOTPRINT)
    assert_same_store(jdb.store, back.store, "JAX coalesced dir -> port")
    back.durability.close()


def test_port_round_trip_across_grow(tmp_path):
    """The port's own checkpoint round trip across pool growth: a full save
    before the pools grow, a delta after (shape-changed arrays go in
    full), a WAL tail; recovery equals the port's live store."""
    db = T.Uruv(_small(), device="cpu", policy=_policy(True),
                durable_dir=tmp_path)
    plans = _fig9b_shape(_plans(13, 16, 16))
    for i, p in enumerate(plans, 1):
        db.apply(p)
        if i == 2:
            db.checkpoint()
            small = db.capacity
        elif i == 12:
            db.checkpoint()
    assert db.stats["grows"] >= 1 and db.capacity != small
    import json

    man = json.loads((tmp_path / "ckpt" / f"step_{12 * 16:08d}" /
                      "manifest.json").read_text())
    assert man["kind"] == "delta"
    assert {r["mode"] for r in man["leaves"]} >= {"full", "same"}
    back = T.Uruv.recover(tmp_path, device="cpu", policy=_policy(True))
    assert back.recovery.replayed_plans == 4
    assert back.capacity == db.capacity
    assert back.ts == db.ts
    assert_same_arrays(to_numpy(db.store), to_numpy(back.store), "grown")
    db.durability.close()
    back.durability.close()


def test_delta_writes_only_the_version_tail(tmp_path):
    """Between compactions the version pool's delta is its allocator tail
    (``version_tail_start``): one ``rows`` entry per version array, rows
    [n_vers at the base, n_vers now)."""
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu",
                policy=T.FIXED_FOOTPRINT, durable_dir=tmp_path)
    db.insert(np.arange(40, dtype=np.int32), np.arange(40, dtype=np.int32))
    db.checkpoint()
    n0 = int(db.store.n_vers)
    db.insert(np.arange(10, dtype=np.int32), np.full(10, 5, np.int32))
    step = db.checkpoint()
    n1 = int(db.store.n_vers)
    d = tmp_path / "ckpt" / f"step_{step:08d}"
    with np.load(d / ".ver_value.npz") as z:
        np.testing.assert_array_equal(z["idx"], np.arange(n0, n1))
        np.testing.assert_array_equal(z["rows"],
                                      np.full(n1 - n0, 5, np.int32))
    db.durability.close()


def test_durable_client_refuses_history_and_checkpoint_needs_dir(tmp_path):
    db = T.Uruv(_small(), device="cpu", durable_dir=tmp_path)
    db.insert([1], [1])
    db.durability.close()
    with pytest.raises(ValueError, match="durable history"):
        T.Uruv(_small(), device="cpu", durable_dir=tmp_path)
    with pytest.raises(ValueError, match="durable client"):
        T.Uruv(_small(), device="cpu").checkpoint()
    T.Uruv(_small(), device="cpu").sync_durable()      # volatile: no-op


def test_group_commit_crash_loses_at_most_window(tmp_path):
    db = T.Uruv(_small(), device="cpu", durable_dir=tmp_path,
                group_commit=4)
    db.insert([1, 2, 3], [10, 20, 30])
    db.insert([4], [40])
    assert db.durability.wal.pending == 2
    db.sync_durable()
    db.insert([5], [50])
    assert db.durability.wal.pending == 1
    del db
    db2 = T.Uruv.recover(tmp_path, device="cpu", group_commit=4)
    assert db2.ts >= 4
    assert db2.lookup([1, 2, 3, 4], db2.ts).tolist() == [10, 20, 30, 40]
    db2.durability.close()


# ---------------------------------------------------------------------------
# the kill -9 battery on the port (workers import no JAX)
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import os, sys
    import numpy as np
    sys.modules["jax"] = None                # the worker runs without JAX
    import repro_torch.api as T

    d = os.environ["URUV_W_DIR"]
    seed, n_plans, width = (int(os.environ[k]) for k in
                            ("URUV_W_SEED", "URUV_W_PLANS", "URUV_W_WIDTH"))
    ckpt_every = int(os.environ["URUV_W_CKPT"])
    maintain = os.environ["URUV_W_MAINTAIN"] == "1"
    maintain_every = int(os.environ["URUV_W_MAINTAIN_EVERY"])
    p = (0.60, 0.25, 0.10, 0.05)              # the "update" mix
    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(n_plans):                  # _wal_workload.make_plans
        r = rng.random(width)
        codes = np.full(width, T.OP_SEARCH, np.int32)
        codes[r < p[0]] = T.OP_INSERT
        codes[(r >= p[0]) & (r < p[0] + p[1])] = T.OP_DELETE
        codes[r >= 1.0 - p[3]] = T.OP_RANGE
        keys = rng.integers(0, 120, width).astype(np.int32)
        values = np.where(codes == T.OP_INSERT,
                          rng.integers(1, 100000, width), 0).astype(np.int32)
        rng_ops = codes == T.OP_RANGE
        values[rng_ops] = keys[rng_ops] + rng.integers(0, 30, width)[rng_ops]
        plans.append(T.OpBatch(codes, keys, values))
    if os.environ.get("URUV_W_DUMP"):
        np.savez(os.environ["URUV_W_DUMP"],
                 **{f"{f}{i}": getattr(pl, f) for i, pl in enumerate(plans)
                    for f in ("codes", "keys", "values")})
        sys.exit(0)
    policy = T.LifecyclePolicy(auto_grow=True, auto_maintain=maintain,
                               version_gc_fraction=2.0)
    if os.path.exists(os.path.join(d, "uruv.json")):
        db = T.Uruv.recover(d, device="cpu", policy=policy)
    else:
        db = T.Uruv(T.UruvConfig(leaf_cap=8, max_leaves=16, max_versions=128,
                                 tracker_cap=8),
                    device="cpu", durable_dir=d, policy=policy)
    assert db.ts % width == 0, (db.ts, width)
    for i in range(db.ts // width, n_plans):
        db.apply(plans[i])
        print(f"acked {i + 1}", flush=True)
        if ckpt_every and (i + 1) % ckpt_every == 0:
            db.checkpoint()
        if maintain_every and (i + 1) % maintain_every == 0:
            db.maintain()
    db.durability.close()
    assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items()
                         if v is not None}
    print("done", flush=True)
''')


def _worker(durable_dir, *, seed, n_plans, width, ckpt=0, crash=None,
            maintain=False, maintain_every=0, expect_kill, dump=None):
    env = {k: v for k, v in os.environ.items()
           if k != T_fault.CRASH_POINT_ENV}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update({
        "URUV_W_DIR": str(durable_dir), "URUV_W_SEED": str(seed),
        "URUV_W_PLANS": str(n_plans), "URUV_W_WIDTH": str(width),
        "URUV_W_CKPT": str(ckpt), "URUV_W_MAINTAIN": "1" if maintain else "0",
        "URUV_W_MAINTAIN_EVERY": str(maintain_every),
    })
    if dump is not None:
        env["URUV_W_DUMP"] = str(dump)
    if crash is not None:
        env[T_fault.CRASH_POINT_ENV] = crash
    p = subprocess.run([sys.executable, "-c", WORKER], env=env,
                       capture_output=True, text=True, timeout=600)
    if expect_kill:
        assert p.returncode == -signal.SIGKILL, \
            f"worker survived its crash point: rc={p.returncode}\n{p.stderr}"
    else:
        assert p.returncode == 0, p.stderr
    acked = [int(line.split()[1]) for line in p.stdout.splitlines()
             if line.startswith("acked ")]
    return max(acked, default=0)


def test_worker_plans_equal_the_reference_workload(tmp_path):
    """The JAX-free worker builds exactly ``_wal_workload.make_plans``."""
    _worker(tmp_path, seed=7, n_plans=12, width=16, expect_kill=False,
            dump=tmp_path / "plans.npz")
    with np.load(tmp_path / "plans.npz") as z:
        for i, p in enumerate(_plans(7, 12, 16)):
            for f in ("codes", "keys", "values"):
                np.testing.assert_array_equal(z[f"{f}{i}"], getattr(p, f))


# (crash selector, checkpoint cadence), as in tests/test_wal_recovery.py
BATTERY = [
    ("wal.mid_append:2", 0),
    ("wal.mid_append:7", 4),
    ("wal.pre_fsync:9", 4),
    ("wal.post_fsync:3", 0),
    ("wal.post_fsync:10", 4),
    ("ckpt.tmp_written", 4),
    ("ckpt.tmp_written:2", 4),
    ("ckpt.renamed", 4),
    ("ckpt.renamed:2", 4),
]


@pytest.mark.parametrize("crash,ckpt", BATTERY, ids=[c for c, _ in BATTERY])
def test_kill9_battery(tmp_path, crash, ckpt):
    seed, n_plans, width = 7, 12, 16
    acked = _worker(tmp_path, seed=seed, n_plans=n_plans, width=width,
                    ckpt=ckpt, crash=crash, expect_kill=True)
    plans = _plans(seed, n_plans, width)
    db = T.Uruv.recover(tmp_path, device="cpu", policy=_policy(False))
    assert db.ts % width == 0
    m = db.ts // width
    # the durability invariant: everything acked survived the kill
    assert acked <= m <= n_plans, (acked, m)
    step = db.recovery.checkpoint_step
    assert db.recovery.replayed_plans + (0 if step is None
                                         else step // width) == m
    assert W.summarize(db) == W.ref_summary(plans, m)
    db.durability.close()

    # a recovered directory is a working store: finish the workload in a
    # resuming worker, recover again, compare the full run
    _worker(tmp_path, seed=seed, n_plans=n_plans, width=width, ckpt=ckpt,
            expect_kill=False)
    db2 = T.Uruv.recover(tmp_path, device="cpu", policy=_policy(False))
    assert db2.ts == n_plans * width
    assert W.summarize(db2) == W.ref_summary(plans, n_plans)
    db2.durability.close()


def test_mid_append_tear_is_truncated_byte_exactly(tmp_path):
    width = 16
    _worker(tmp_path, seed=11, n_plans=8, width=width,
            crash="wal.mid_append:5", expect_kill=True)
    db = T.Uruv.recover(tmp_path, device="cpu", policy=_policy(False))
    rep = db.recovery.wal
    rec_bytes = REC_HEADER.size + PAY_HEADER.size + 12 * width
    assert rep.torn_tail
    assert rep.truncated_bytes == rec_bytes // 2
    assert rep.truncated_segment == "wal_00000001.log"
    assert db.ts // width == 4          # plans 1-4 survived, 5 was torn
    db.durability.close()
    db2 = T.Uruv.recover(tmp_path, device="cpu", policy=_policy(False))
    assert not db2.recovery.wal.torn_tail
    db2.durability.close()


def test_recovery_across_maintain_boundary(tmp_path):
    seed, n_plans, width = 3, 16, 12
    acked = _worker(tmp_path, seed=seed, n_plans=n_plans, width=width,
                    ckpt=5, crash="wal.post_fsync:11", maintain=True,
                    maintain_every=3, expect_kill=True)
    plans = _plans(seed, n_plans, width)
    db = T.Uruv.recover(tmp_path, device="cpu", policy=_policy(True))
    m = db.ts // width
    assert acked <= m <= n_plans
    assert W.summarize(db, historical=False) == \
        W.ref_summary(plans, m, historical=False)
    with db.snapshot() as ts:
        before = db.range(0, W.KEYSPACE, ts)
        db.maintain()
        db.compact()
        assert db.range(0, W.KEYSPACE, ts) == before
    db.durability.close()
