"""The port's spans and counters (``repro_torch.tracing``), on the CPU.

Tracing off records nothing and tracing on changes no result; spans nest
by layer and carry their plan's id (a ``confirm`` and a replay too); self
time is a span's duration minus its children's union; each device-to-host
read of a plan is counted at its site; the front end hands over one queue
wait a request.  The one ``cuda`` test holds a span against the device
trace's clock on the card.  The file imports no jax.
"""

import collections
import gc
import json

import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch import tracing
from repro_torch.core import store as TS
from repro_torch.kernels import _build
from repro_torch.serve.coalescer import AdmissionPolicy, Coalescer

CFG = dict(leaf_cap=16, max_leaves=256, max_versions=1 << 13, tracker_cap=16,
           max_chain=16, index_fanout=4)
UNIVERSE = 2000


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with tracing off and nothing kept."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _client(**over):
    db = T.Uruv(T.UruvConfig(**dict(CFG, **over)), device="cpu")
    keys = np.arange(2, UNIVERSE, 4, dtype=np.int32)
    for i in range(0, len(keys), 100):
        db.insert(keys[i:i + 100], keys[i:i + 100] + 1)
    return db


def _crud(rng, n, mix=(0.5, 0.25, 0.25)):
    codes = rng.choice([T.OP_SEARCH, T.OP_INSERT, T.OP_DELETE], n,
                       p=mix).astype(np.int32)
    keys = rng.integers(1, UNIVERSE, n).astype(np.int32)
    return T.OpBatch(codes, keys, rng.integers(1, 1 << 20, n)
                     .astype(np.int32))


def _mixed(rng, n):
    """A fig9b-style plan: searches, inserts and deletes, then ranges."""
    lo = rng.integers(1, UNIVERSE - 200, 4).astype(np.int32)
    return T.OpBatch.concat(_crud(rng, n, (0.9, 0.05, 0.05)),
                            T.OpBatch.ranges(lo, lo + 150))


def _run(db, kind, seed):
    """Four plans of one kind; every result and the final store."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        if kind == "mixed":
            out.append(db.apply(_mixed(rng, 48)))
            continue
        pending = db.apply_nowait(_crud(rng, 48))
        res = db.confirm(pending)
        out.append(res if res is not None else db.apply(pending.batch))
    return out, TS.to_numpy(db.store), db.live_items()


def _same_result(a, b):
    for f in ("values", "found", "timestamps", "range_index",
              "range_resume"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(a.range_pages) == len(b.range_pages)
    for pa, pb in zip(a.range_pages, b.range_pages):
        np.testing.assert_array_equal(pa, pb)


def _names(spans):
    return [s[0] for s in spans]


def test_off_records_nothing_and_counts_reads():
    db = _client()
    assert tracing.span("api.apply") is tracing.NO_SPAN
    before = tracing.counters["host_reads.store.precheck"]
    db.apply(_crud(np.random.default_rng(1), 32))
    rec = tracing.take()
    assert rec["spans"] == [] and rec["waits_s"].size == 0
    assert tracing.counters["host_reads.store.precheck"] == before + 1


@pytest.mark.parametrize("kind", ["crud_pipelined", "mixed"])
def test_results_are_identical_with_tracing_on_and_off(kind):
    off = _run(_client(), kind, seed=7)
    tracing.enable()
    on = _run(_client(), kind, seed=7)
    tracing.disable()
    assert len(tracing.take()["spans"]) > 0
    for a, b in zip(off[0], on[0]):
        _same_result(a, b)
    assert off[1].keys() == on[1].keys()
    for k in off[1]:
        np.testing.assert_array_equal(off[1][k], on[1][k], err_msg=k)
    assert off[2] == on[2]


def test_spans_nest_by_layer_and_share_the_plan_id():
    db = _client()
    tracing.enable()
    db.apply(T.OpBatch.inserts(np.arange(1, 40, 4), 5))   # new keys
    spans = tracing.take()["spans"]
    by = {s[0]: i for i, s in enumerate(spans)}
    chain = ["api.apply", "batch.apply_mixed", "batch.round",
             "store.bulk_apply", "store.structural"]
    for outer, inner in zip(chain, chain[1:]):
        assert spans[by[inner]][3] == by[outer], (outer, inner)
    assert spans[by["sync.store.precheck"]][3] == by["store.bulk_apply"]
    assert spans[by["api.apply"]][3] == -1
    plan = spans[0][4]
    assert plan > 0 and all(s[4] == plan for s in spans)
    for name, a, b, parent, _ in spans:
        assert a <= b
        if parent >= 0:
            assert spans[parent][1] <= a and b <= spans[parent][2]


def test_confirm_and_a_replay_carry_their_plan_id():
    db = _client(leaf_cap=8)
    tracing.enable()
    ok = db.apply_nowait(T.OpBatch.searches(np.arange(2, 60, 4)))
    assert db.confirm(ok) is not None
    # 20 new keys for the last leaf, of 8: the pass rejects, the plan
    # replays
    bad = db.apply_nowait(T.OpBatch.inserts(
        np.arange(UNIVERSE, UNIVERSE + 20), 9))
    assert db.confirm(bad) is None
    db.apply(bad.batch)
    spans = tracing.take()["spans"]
    tops = [(s[0], s[4]) for s in spans if s[3] == -1]
    assert ok.plan_id and bad.plan_id and ok.plan_id != bad.plan_id
    assert tops == [("api.apply_nowait", ok.plan_id),
                    ("api.confirm", ok.plan_id),
                    ("api.apply_nowait", bad.plan_id),
                    ("api.confirm", bad.plan_id),
                    ("api.apply", bad.plan_id)]
    assert {s[4] for s in spans} == {ok.plan_id, bad.plan_id}


def test_self_time_by_hand():
    spans = [("a", 0, 100, -1, 1),
             ("b", 10, 40, 0, 1),
             ("c", 30, 60, 0, 1),          # overlaps b: the union counts
             ("d", 15, 20, 1, 1),
             ("e", 90, 120, 0, 1),         # runs past its parent's end
             ("f", 200, 210, -1, 0)]
    assert tracing.self_ns(spans) == [100 - 50 - 10, 30 - 5, 30, 5, 30, 10]


def test_host_read_sites_of_one_plan_are_pinned():
    db = _client()
    rng = np.random.default_rng(3)
    expect = {
        # Uruv.apply of CRUD ops with new keys: the clock, the pass's two
        # flag reads, the results, the lifecycle's trigger
        "apply": {"api.clock": 1, "store.precheck": 1,
                  "store.index_oflow": 1, "batch.results": 1,
                  "lifecycle.tick": 1},
        # apply_nowait of ops on existing keys, then confirm
        "pipelined": {"store.precheck": 1, "api.clock": 1,
                      "api.confirm": 1},
        # 4 RANGEs beside CRUD: the segment clock and one page's 5 arrays
        "mixed": {"api.clock": 1, "batch.clock": 1, "store.precheck": 2,
                  "store.index_oflow": 1, "batch.results": 2,
                  "batch.range_page": 5, "lifecycle.tick": 1},
    }
    plans = {
        "apply": lambda: db.apply(T.OpBatch.inserts(np.arange(1, 60, 4), 5)),
        "pipelined": lambda: db.confirm(db.apply_nowait(T.OpBatch.concat(
            T.OpBatch.searches(np.arange(2, 40, 4)),
            T.OpBatch.inserts(np.arange(42, 80, 4), 3)))),
        "mixed": lambda: db.apply(T.OpBatch.concat(
            T.OpBatch.inserts([101, 105], 1), T.OpBatch.ranges(
                rng.integers(1, 1000, 4), 1200),
            T.OpBatch.searches([2, 6]))),
    }
    for name, run in plans.items():
        tracing.take()
        run()
        got = {k[len("host_reads."):]: v
               for k, v in tracing.take()["counters"].items()
               if k.startswith("host_reads.")}
        assert got == expect[name], name


def test_each_request_gets_one_queue_wait():
    db = _client()
    c = Coalescer(db, AdmissionPolicy(start_width=16, max_width=64))
    rng = np.random.default_rng(5)
    tracing.enable()
    futs = [c.submit(_crud(rng, int(rng.integers(1, 5)))) for _ in range(60)]
    c.flush()
    tracing.disable()
    waits = tracing.take()["waits_s"]
    assert len(waits) == len(futs)
    for w, f in zip(waits, futs):        # dispatched in submit order
        assert 0 <= w <= f.done_t - f.submit_t
        assert w == f.dispatch_t - f.submit_t


def test_a_collection_is_a_gc_span_under_the_open_span():
    tracing.enable()
    with tracing.span("outer", plan=tracing.new_plan()):
        gc.collect()
    spans = tracing.take()["spans"]
    assert _names(spans)[0] == "outer" and "python.gc" in _names(spans)
    g = spans[_names(spans).index("python.gc")]
    assert g[3] == 0 and g[4] == spans[0][4]


def test_launch_counts_is_the_launch_group_of_the_counters():
    tracing.counters["host_reads.test.site"] += 1
    _build.launch_counts["test_kernel"] += 2
    assert tracing.counters["launch.test_kernel"] == 2
    assert dict(_build.launch_counts)["test_kernel"] == 2
    _build.launch_counts.clear()
    assert len(_build.launch_counts) == 0
    assert tracing.counters["host_reads.test.site"] >= 1
    del tracing.counters["host_reads.test.site"]


@pytest.mark.cuda
def test_a_span_holds_the_kernels_it_waited_for_on_the_device_clock(
        tmp_path):
    """A span around ``torch.cuda._sleep`` and a synchronize contains the
    kernel's interval in a ``torch.profiler`` trace, within 50 us, as
    ``uruvbench.devtrace.read_trace`` reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from uruvbench.devtrace import read_trace

    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    tracing.enable()
    with tracing.span("sleep"):
        torch.cuda._sleep(20_000_000)            # ~10 ms at ~2 GHz
        torch.cuda.synchronize()
    tracing.disable()
    prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    (name, a, b, _, _), = tracing.take()["spans"]
    facts = read_trace(trace, [(name, a, b)], a, b, (b - a) / 1e9)
    idle = sum(s for label, s in facts["idle_gaps"])
    assert facts["kernels"] == 1 and facts["busy_s"] > 5e-3, facts
    # the kernel inside the span: idle + busy fill the span exactly;
    # any part of it outside the span adds to the sum
    assert abs(idle + facts["busy_s"] - (b - a) / 1e9) <= 50e-6, facts
    assert collections.Counter(label for label, _ in
                               facts["idle_gaps"]) == {"sleep": 1}
