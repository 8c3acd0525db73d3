"""The port's serving stack against the JAX package's, on the CPU.

Mirrors ``tests/test_serve_pipeline.py`` (pipelined ``apply_nowait`` /
``confirm``, the coalescer's futures, forced rejection and replay) and the
engine cases of ``tests/test_data_serve.py`` on the port's ``Engine``;
the coalescer's dispatch log is replayed through the JAX client as well
as the port's, and must give bit-equal per-request results.  A JAX engine
and a port engine with the same weights and requests must generate the
same tokens, reuse the same prefixes and show the same prefix table.
"""

import collections

import numpy as np
import pytest
import jax
import torch

from repro import api as J
from repro.config import get_arch as j_get_arch
from repro.models.registry import get_model as j_get_model
from repro.serve.engine import (
    Engine as JEngine, Request as JRequest, prefix_hash as j_prefix_hash,
)

import repro_torch.api as T
from repro_torch.config import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import params_from_numpy
from repro_torch.serve.coalescer import AdmissionPolicy, Coalescer, OpFuture
from repro_torch.serve.engine import Engine, Request, prefix_hash

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    assert_same_store, fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

CFG = dict(leaf_cap=8, max_leaves=512, max_versions=1 << 14, max_chain=16)


def _pair(**over):
    cfg = dict(CFG, **over)
    return (J.Uruv(J.UruvConfig(**cfg), backend="xla"),
            T.Uruv(T.UruvConfig(**cfg), device="cpu"))


def _same_result(j, t, n=None):
    for f in ("values", "found", "timestamps"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f))[:n],
                                      np.asarray(getattr(t, f))[:n])


# --------------------------------------------------------------- sentinels
def test_prefix_hash_matches_jax_and_never_emits_sentinels():
    fnv, mul = 2166136261, 16777619
    t_keymax = (T.KEY_MAX - 1 - fnv * mul) % (2 ** 31)
    t_pad = (T.KEY_MAX - 2 - fnv * mul) % (2 ** 31)
    for tokens in ([t_keymax], [t_pad], [0], [1, 2, 3], list(range(64)),
                   [5, 17, 5, 99]):
        h = prefix_hash(tokens)
        assert h == j_prefix_hash(tokens)
        assert 1 <= h <= T.KEY_DOMAIN_HI - 1
    assert prefix_hash([1, 2, 3]) != prefix_hash([1, 2, 4])
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    for t in ([t_keymax], [t_pad]):
        k = prefix_hash(t)
        db.apply(T.OpBatch.inserts([k], [777]))
        assert int(db.lookup([k])[0]) == 777


# --------------------------------------------------- apply_nowait / confirm
def test_apply_nowait_confirm_matches_sync_apply_and_jax():
    rng = np.random.default_rng(3)
    jdb, tdb = _pair()
    sync = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    for _ in range(8):
        n = int(rng.integers(1, 20))
        keys = rng.integers(1, 500, n).astype(np.int32)
        codes = rng.integers(0, 3, n).astype(np.int32)
        vals = (keys % 97 + 1).astype(np.int32)
        got = []
        for mod, db in ((J, jdb), (T, tdb)):
            pending = db.apply_nowait(mod.OpBatch(codes, keys, vals),
                                      pad_to_pow2=True)
            res = db.confirm(pending)
            if res is None:                    # rejected: replay
                res = db.apply(pending.batch)
            got.append(res)
        _same_result(got[0], got[1], n)
        _same_result(sync.apply(T.OpBatch(codes, keys, vals),
                                pad_to_pow2=True), got[1], n)
    assert jdb.ts == tdb.ts == sync.ts
    assert_same_store(jdb.store, tdb.store, "after the pipelined plans")


def test_apply_nowait_rejects_range_and_empty():
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="RANGE"):
        db.apply_nowait(T.OpBatch.ranges([1], [5]))
    with pytest.raises(ValueError, match="non-empty"):
        db.apply_nowait(T.OpBatch.empty())


def test_rejection_rolls_back_and_replays_bit_exact():
    keys = np.arange(1, 33, dtype=np.int32)
    jdb, tdb = _pair()
    out = []
    for mod, db in ((J, jdb), (T, tdb)):
        ts0 = db.ts
        pending = db.apply_nowait(mod.OpBatch.inserts(keys, keys * 10),
                                  pad_to_pow2=True)
        assert db.confirm(pending) is None     # leaf_cap=8: rejected
        assert db.ts == ts0
        res = db.apply(pending.batch)
        assert np.asarray(res.timestamps)[0] == ts0
        out.append(res)
    _same_result(out[0], out[1])
    assert_same_store(jdb.store, tdb.store, "after the replay")
    db2 = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    res2 = db2.apply(T.OpBatch.inserts(keys, keys * 10), pad_to_pow2=True)
    np.testing.assert_array_equal(out[1].values[:32], res2.values)
    assert db2.ts == tdb.ts
    # a donated plan rolls back from the rejected pass's own store
    p = tdb.apply_nowait(T.OpBatch.inserts(keys + 1000, keys),
                         pad_to_pow2=True, donate_store=True)
    assert p.store_before is None
    assert tdb.confirm(p) is None and int(tdb.store.oflow) == 0
    assert tdb.ts == db2.ts and tdb.lookup([1001])[0] == T.NOT_FOUND


def test_depth_two_speculation_sees_prior_plan():
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    p1 = db.apply_nowait(T.OpBatch.inserts([10, 11], [100, 110]),
                         pad_to_pow2=True)
    p2 = db.apply_nowait(T.OpBatch.searches([10, 11]), pad_to_pow2=True)
    r1, r2 = db.confirm(p1), db.confirm(p2)
    assert r1 is not None and r2 is not None
    assert r2.values.tolist() == [100, 110]


# ------------------------------------------------------------- coalescer
def _mirror_check(coalescer, futures, cfg, prefill, mod, make_db):
    """Replay the coalescer's dispatch log through a synchronous client of
    ``mod`` and demand bit-exact per-request results."""
    db2 = make_db()
    if prefill is not None:
        db2.apply(mod.OpBatch(*prefill))
    resolved = {}
    for plan, spans in coalescer.dispatch_log:
        res = db2.apply(mod.OpBatch(plan.codes, plan.keys, plan.values))
        for fut, a, b in spans:
            resolved[id(fut)] = (
                np.asarray(res.values)[a:b], np.asarray(res.found)[a:b],
                np.asarray(res.timestamps)[a:b],
                [(int(p) - a, res.page(int(p)))
                 for p in np.asarray(res.range_index) if a <= int(p) < b])
    assert len(resolved) == len(futures)
    for fut in futures:
        got = fut.result()
        want_v, want_f, want_t, want_pages = resolved[id(fut)]
        np.testing.assert_array_equal(got.values, want_v)
        np.testing.assert_array_equal(got.found, want_f)
        np.testing.assert_array_equal(got.timestamps, want_t)
        assert [(int(p), got.page(int(p))) for p in got.range_index] == \
            want_pages
    return db2


def test_coalescer_bit_exact_under_skewed_bursty_load():
    """Zipf-skewed bursty traffic with RANGE-mixed requests through the
    port's pipelined coalescer: per request, the values, found flags,
    timestamps and range pages of the same coalesced plans applied
    synchronously — by the port's client and by the JAX client."""
    rng = np.random.default_rng(17)
    hot = rng.choice(2000, 24, replace=False).astype(np.int32) + 1
    prefill = (np.full(24, T.OP_INSERT, np.int32), hot, hot * 3)
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    db.apply(T.OpBatch(*prefill))
    c = Coalescer(db, AdmissionPolicy(start_width=16, max_width=64,
                                      base_deadline_s=1e-4), record=True)
    futures = []
    for wave in range(12):
        for _ in range(int(rng.integers(2, 10))):
            parts = []
            for _ in range(int(rng.integers(1, 5))):
                r = rng.random()
                k = int(hot[rng.integers(0, 4)]) if r < 0.7 \
                    else int(rng.integers(1, 4000))
                if r < 0.25:
                    parts.append(T.OpBatch.inserts([k], [k % 89 + 1]))
                elif r < 0.4:
                    parts.append(T.OpBatch.deletes([k]))
                elif r < 0.9:
                    parts.append(T.OpBatch.searches([k]))
                else:
                    parts.append(T.OpBatch.ranges([k], [k + 50]))
            futures.append(c.submit(T.OpBatch.concat(*parts)))
        c.pump(force=bool(wave % 3 == 0))
        if wave % 4 == 1:
            futures[int(rng.integers(0, len(futures)))].result()
    c.flush()
    assert all(f.done for f in futures)
    assert c.stats["plans"] == len(c.dispatch_log)
    assert c.stats["plans_sync"] > 0
    _mirror_check(c, futures, CFG, prefill, T,
                  lambda: T.Uruv(T.UruvConfig(**CFG), device="cpu"))
    jdb = _mirror_check(c, futures, CFG, prefill, J,
                        lambda: J.Uruv(J.UruvConfig(**CFG), backend="xla"))
    assert_same_store(jdb.store, db.store, "coalesced == JAX replay")


def test_coalescer_rejection_replay_bit_exact():
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    c = Coalescer(db, AdmissionPolicy(start_width=64, max_width=64),
                  record=True)
    futures = [c.submit(T.OpBatch.inserts(np.arange(100, 132,
                                                    dtype=np.int32), 7))]
    c.pump(force=True)
    futures.append(c.submit(T.OpBatch.searches(np.arange(100, 104,
                                                         dtype=np.int32))))
    c.pump(force=True)
    c.flush()
    assert c.stats["plans_rejected"] >= 1 and c.stats["replays"] >= 2
    jdb = _mirror_check(c, futures, CFG, None, J,
                        lambda: J.Uruv(J.UruvConfig(**CFG), backend="xla"))
    assert_same_store(jdb.store, db.store, "rejection replay == JAX")


def test_coalescer_deep_queue_drains_fifo():
    db = T.Uruv(T.UruvConfig(leaf_cap=64, max_leaves=1 << 11,
                             max_versions=1 << 15), device="cpu")
    c = Coalescer(db, AdmissionPolicy(start_width=64, max_width=64))
    n = 10_000
    keys = np.random.default_rng(5).choice(200_000, n, replace=False) \
        .astype(np.int32) + 1
    futs = [c.submit(T.OpBatch.inserts([int(k)], [int(k) % 50 + 1]))
            for k in keys]
    assert isinstance(c.queue, collections.deque)
    assert c.stats["max_queue_depth"] == n
    c.flush()
    ts = np.array([int(f.result().timestamps[0]) for f in futs])
    assert (np.diff(ts) > 0).all()
    assert db.lookup(keys[:100]).tolist() == \
        [int(k) % 50 + 1 for k in keys[:100]]


def test_coalescer_exclusive_single_depth_and_width_adaptation():
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    c = Coalescer(db, AdmissionPolicy(start_width=8), exclusive=True)
    assert c._depth == 1
    futs = [c.submit(T.OpBatch.inserts([k], [k * 2])) for k in range(1, 9)]
    c.flush()
    assert [int(f.result().values[0]) for f in futs] == [-1] * 8
    assert db.lookup(np.arange(1, 9)).tolist() == \
        (np.arange(1, 9) * 2).tolist()
    db = T.Uruv(T.UruvConfig(**CFG), device="cpu")
    c = Coalescer(db, AdmissionPolicy(start_width=64, max_width=64))
    c.submit(T.OpBatch.inserts(np.arange(1, 33, dtype=np.int32), 1))
    c.flush()
    assert c.target_width < 64
    c2 = Coalescer(db, AdmissionPolicy(start_width=8))
    for _ in range(8):
        c2.submit(T.OpBatch.inserts([77], [1]))
    c2.flush()
    assert c2.stats["hot_segments"] >= 1
    assert c2._deadline_s() < c2.policy.base_deadline_s
    assert not OpFuture(c2, 1).done


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_arch("llama3_2_1b").reduced()
    cfg = get_arch("llama3_2_1b").reduced()
    jp = j_get_model(jcfg).init(jcfg, jax.random.key(0))
    return jcfg, cfg, jp, params_from_numpy(cfg, jax.device_get(jp), "cpu")


def test_select_donor_and_completed_donor(tiny):
    pack = lambda slot, ln: (slot << 16) | ln    # noqa: E731
    assert Engine._select_donor([1, 2, 3], [pack(0, 1), pack(1, 2), -1]) \
        == (1, 2)
    assert Engine._select_donor([3], [pack(0, 2)]) == (-1, 0)
    assert Engine._select_donor([1, 2], [-1, -1]) == (-1, 0)
    _, cfg, _, params = tiny
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 6).tolist()
    eng = Engine(cfg, params, n_slots=2, max_len=32, device="cpu")
    r = Request(rid=0, prompt=prompt, max_new=2)
    eng.run([r])
    assert r.done and all(s is None for s in eng.slot_req)
    assert eng._lookup_prefix(prompt + [1]) == (0, len(prompt))


def test_engine_generates_and_reuses_prefix(tiny):
    _, cfg, _, params = tiny
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 5).tolist()
    p1, p2 = shared + [7, 8], shared + [9]
    outs_ref = []
    for p in (p1, p2):
        eng = Engine(cfg, params, n_slots=2, max_len=32, device="cpu")
        r = Request(rid=0, prompt=p, max_new=5)
        eng.run([r])
        outs_ref.append(r.out)
    eng = Engine(cfg, params, n_slots=2, max_len=32, device="cpu")
    r1 = Request(rid=1, prompt=p1, max_new=5)
    eng.run([r1])
    r2 = Request(rid=2, prompt=p2, max_new=5)
    eng.run([r2])
    assert r1.out == outs_ref[0]
    assert r2.out == outs_ref[1], "prefix reuse changed the output"
    view = eng.snapshot_view()
    mid = view[len(view) // 2][0]
    lo_v, hi_v = eng.snapshot_views([(0, mid), (mid + 1, T.KEY_DOMAIN_HI)])
    assert lo_v + hi_v == view
    assert eng.table.active_snapshots == 0


def test_engine_continuous_batching(tiny):
    _, cfg, _, params = tiny
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               3 + i).tolist(), max_new=4)
            for i in range(5)]
    eng = Engine(cfg, params, n_slots=2, max_len=32, device="cpu")
    eng.run(reqs)
    assert all(r.done and len(r.out) == 4 for r in reqs)


def test_engine_matches_jax_engine(tiny):
    """The same weights and requests through both engines: the same
    tokens, prefix reuse, prefix table and table counters.  The requests
    share a system prompt and include follow-up turns, so both cold
    prefills and prefix copies with step-by-step feeds run."""
    jcfg, cfg, jp, params = tiny
    rng = np.random.default_rng(4)
    system = rng.integers(0, cfg.vocab, 6).tolist()

    def turn(prefix):
        return prefix + rng.integers(0, cfg.vocab,
                                     int(rng.integers(2, 5))).tolist()
    first = [turn(system) for _ in range(3)]
    waves = [first, [turn(first[1]), turn(first[2]), turn(first[0])]]
    je = JEngine(jcfg, jp, n_slots=3, max_len=40)
    te = Engine(cfg, params, n_slots=3, max_len=40, device="cpu")
    for w, prompts in enumerate(waves):
        jr = [JRequest(rid=i, prompt=p, max_new=4)
              for i, p in enumerate(prompts)]
        tr = [Request(rid=i, prompt=p, max_new=4)
              for i, p in enumerate(prompts)]
        je.run(jr)
        te.run(tr)
        assert [r.out for r in tr] == [r.out for r in jr]
        assert [r.prefix_reused for r in tr] == \
            [r.prefix_reused for r in jr]
    assert any(r.prefix_reused for r in tr)
    assert te.snapshot_view() == je.snapshot_view()
    bounds = [(0, 1 << 30), ((1 << 30) + 1, T.KEY_DOMAIN_HI)]
    assert te.snapshot_views(bounds) == je.snapshot_views(bounds)
    assert te.table_stats == je.table_stats
    assert_same_store(je.table.store, te.table.store, "prefix tables")


def test_launch_serve_on_cpu_and_cuda_default(capsys):
    launch_serve.main(["--arch", "olmo_1b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "reused_prefix" in out and "tok/s" in out and "cpu" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_serve.build_engine("llama3_2_1b", reduced=True)
