"""The benchmark's harness on the CPU, at tiny sizes, through the port.

Each cell's own data files are copied to a temporary root with the key
counts, pools and widths cut down; the code that runs is the code the
card runs.  The device's numbers are not read here (no card): the traced
run reports the program's counters only.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uruvbench import compare, harness, roofline
from uruvbench.devtrace import read_trace
from uruvbench.reference import NOT_FOUND, OP_DELETE, OP_INSERT, OP_NOP, OP_RANGE, OP_SEARCH

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 77          # larger than 32 signed bits hold
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def make_tiny_root(dst: Path) -> Path:
    """BENCHMARK.json and uruvbench/'s data under ``dst``, cut to a size a
    CPU runs in about a second a cell."""
    shutil.copytree(REPO / "uruvbench", dst / "uruvbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                  ".traces"))
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(prefill_keys=2000, key_universe=20000)
        cfg["store"].update(max_leaves=256, max_versions=8192)
        if "admission" in cfg:
            cfg["admission"]["max_width"] = 128
        if cfg["popularity"]["kind"] == "zipf":
            cfg["popularity"]["hot_keys"] = 256
        (dst / c["file"]).write_text(json.dumps(cfg))
    for t in (dst / "uruvbench" / "traffic").glob("*.json"):
        mix = json.loads(t.read_text())
        if "width" in mix:
            mix["width"] = 128
        if "clients" in mix:
            mix["clients"] = 32
        t.write_text(json.dumps(mix))
    (dst / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return dst


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("uruvbench"))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a worker: the test run has a process a core,
    and tiny plans need no more (oversubscribed, a plan can outlast the
    window)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_tiny(root, cell, trace=False, seed=SEED, seconds=1.0):
    return harness.run(root, cell, seed, seconds, trace, device="cpu")


def assert_contract(line, metrics):
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert set(line["metrics"]) == set(metrics)
    for name, m in line["metrics"].items():
        assert m["unit"] == metrics[name] and np.isfinite(m["value"])
    json.loads(json.dumps(line))
    assert all(c["limit"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_tiny_and_correct(tiny, cell, trace):
    line = run_tiny(tiny, cell, trace)
    key = "per_layer" if trace else "end_to_end"
    counters = {m["name"]: m["unit"] for m in BENCH[key]
                if cell in m.get("workloads", [cell])
                and m["source"] in ("program_counter", "host_clock")}
    assert_contract(line, counters)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    if not trace:
        assert all(m["value"] > 0 for m in line["metrics"].values())


# --------------------------------------------------------------- faults
def _install(monkeypatch, fault):
    """Break the timed path under the harness once the prefill is in."""
    from repro_torch.api import client, executors

    ex = executors.LocalExecutor
    apply, nowait = ex.apply, ex.apply_nowait

    def halve(batch):
        b = batch.__class__(batch.codes.copy(), batch.keys.copy(),
                            batch.values.copy())
        h = len(b) // 2
        b.codes[h:], b.keys[h:], b.values[h:] = OP_NOP, 2**31 - 1, 0
        return b

    if fault == "state_unchanged":
        def f_apply(self, store, batch, **kw):
            return (store,) + tuple(apply(self, store, batch, **kw)[1:])

        def f_nowait(self, store, batch, **kw):
            return (store,) + tuple(nowait(self, store, batch, **kw)[1:])
        monkeypatch.setattr(ex, "apply", f_apply)
        monkeypatch.setattr(ex, "apply_nowait", f_nowait)
    elif fault == "half_left_out":
        monkeypatch.setattr(ex, "apply", lambda self, store, batch, **kw:
                            apply(self, store, halve(batch), **kw))
        monkeypatch.setattr(ex, "apply_nowait", lambda self, store, batch,
                            **kw: nowait(self, store, halve(batch), **kw))
    elif fault == "answer_lost":            # one future never resolves
        from repro_torch.serve import coalescer

        materialize = coalescer.Coalescer._materialize

        def lose_one(self, spans, res):
            materialize(self, spans[1:] if len(spans) > 1 else spans, res)
        monkeypatch.setattr(coalescer.Coalescer, "_materialize", lose_one)
    elif fault == "requests_reordered":     # a plan's requests out of order
        from repro_torch.serve import coalescer

        concat = coalescer.OpBatch.concat
        monkeypatch.setattr(coalescer.OpBatch, "concat", staticmethod(
            lambda *bs: concat(*bs[::-1])))
    else:
        make = client.make_result

        def altered(values, *a, **kw):
            values = np.array(values)
            values[:1] += 1
            return make(values, *a, **kw)
        monkeypatch.setattr(client, "make_result", altered)


FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("state_unchanged", "half_left_out", "answer_altered")]
FAULTS += [("serving-zipf-c4096", f) for f in ("answer_lost",
                                              "requests_reordered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    from uruvbench import loops

    def prefill_then_break(*a, **kw):
        loops.prefill(*a, **kw)
        _install(monkeypatch, fault)
    monkeypatch.setattr(harness, "prefill", prefill_then_break)
    line = run_tiny(tiny, cell)
    assert not line["correct"]
    assert list(line)[-1] == "checks"
    caught = {"answer_lost": "unanswered",
              "requests_reordered": "misrouted_requests"}.get(fault)
    if caught:
        assert line["checks"][caught]["value"] > 0
    else:
        assert line["failed"] > 0
    print(cell, fault, {k: c["value"] for k, c in line["checks"].items()})


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, monkeypatch, cell):
    """The reference with in-plan linearization broken (every op reads
    the state its plan found), in the program's place."""
    sys.path.insert(0, str(REPO / "uruvbench"))
    try:
        import control
    finally:
        sys.path.remove(str(REPO / "uruvbench"))
    from repro_torch import api

    monkeypatch.setattr(api, "Uruv", control.StaleReadStore)
    line = run_tiny(tiny, cell)
    assert not line["correct"]
    assert line["checks"]["value_mismatches"]["value"] > 0


def test_one_corrupted_answer_is_counted():
    from repro_torch.api import OpBatch, make_result
    from uruvbench.loops import PlanRecord
    from uruvbench.reference import StoreMap

    codes = np.array([OP_INSERT, OP_SEARCH, OP_RANGE], np.int32)
    keys = np.array([3, 3, 1], np.int32)
    vals = np.array([9, 0, 5], np.int32)
    good = make_result([NOT_FOUND, 9, 1], codes, 0, [(2, [(3, 9)], 5)])
    bad = make_result([NOT_FOUND, 8, 1], codes, 0, [(2, [(3, 9)], 5)])
    for res, wrong in ((good, 0), (bad, 1)):
        counts = dict.fromkeys(compare.CHECKS, 0)
        compare.check_plans(StoreMap(10), [PlanRecord(codes, keys, vals, res)],
                            counts)
        assert counts["value_mismatches"] == wrong
        assert compare.wrong_ops(counts) == wrong
    assert OpBatch(codes, keys, vals)   # the plan the record stands for


# ------------------------------------------------------------ yardstick
def test_min_bytes_by_hand():
    codes = np.array([OP_SEARCH, OP_INSERT, OP_SEARCH, OP_DELETE, OP_RANGE,
                      OP_RANGE, OP_NOP], np.int32)
    keys = np.array([7, 7, 8, 9, 1, 50, 2**31 - 1], np.int32)
    # 3 distinct CRUD keys x 64 B, 5 range pairs x 20 B, 6 real ops x 16 B
    assert roofline.plan_min_bytes(codes, keys, 5) == 3 * 64 + 5 * 20 + 6 * 16
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("some other card") is None


def test_trace_reading_by_hand():
    base = 1_000_000_000_000
    ev = [{"cat": "kernel", "name": "a", "ts": 10.0, "dur": 5.0},
          {"cat": "kernel", "name": "a", "ts": 12.0, "dur": 5.0},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
           "ts": 30.0, "dur": 2.0},
          {"cat": "kernel", "name": "b", "ts": 40.0, "dur": 10.0},
          {"cat": "cpu_op", "name": "host", "ts": 0.0, "dur": 99.0}]
    spans = [("apply", base + 0, base + 20_000),
             ("confirm", base + 20_000, base + 45_000)]
    f = read_trace({"baseTimeNanoseconds": base, "traceEvents": ev}, spans,
                   base, base + 60_000, 60e-6)
    assert (f["kernels"], f["d2h_copies"]) == (2 + 1, 1)
    assert f["busy_s"] == pytest.approx((7 + 2 + 10) * 1e-6)
    assert f["device_ops"][0] == ["a", pytest.approx(10e-6)]
    idle = dict(f["idle_gaps"])
    # idle: [0,10) + [17,20) apply; [20,30) + [32,40) confirm; [50,60) other
    assert idle["apply"] == pytest.approx(13e-6)
    assert idle["confirm"] == pytest.approx(18e-6)
    assert idle["other"] == pytest.approx(10e-6)


# --------------------------------------------------------- data-driven
def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    root = make_tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / BENCH["configs"][0]["file"]).read_text())
    cfg["popularity"] = {"kind": "zipf", "s": 0.99, "hot_keys": 512}
    (root / "uruvbench/configs/zipf-small.json").write_text(json.dumps(cfg))
    (root / "uruvbench/traffic/read-heavy-w256.json").write_text(json.dumps(
        {"loop": "plans", "width": 256, "inflight": 1,
         "mix": {"search": 0.9, "insert": 0.05, "delete": 0.05}}))
    (root / "uruvbench/metrics/grows_per_plan.py").write_text(
        "def read(facts):\n"
        "    return facts['uruv']['grows'] / facts['plans']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "zipf-small", "source": "test",
                             "file": "uruvbench/configs/zipf-small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "zipf-small.read", "config":
                               "zipf-small", "traffic": "read-heavy-w256",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "grows_per_plan", "unit": "grows/plan",
                               "better": "lower", "source": "program_counter",
                               "layer": "test", "moves": "ops_per_s",
                               "workloads": ["zipf-small.read"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data
    line = run_tiny(root, "zipf-small.read", trace=True)
    assert line["correct"] and "grows_per_plan" in line["metrics"]
    line = run_tiny(root, "zipf-small.read")
    assert set(line["metrics"]) == {"ops_per_s", "op_latency_p95_ms", "setup_s"}


# ------------------------------------------------------------- the CLI
RUN_AND_LIST = """
import json, sys
from pathlib import Path
sys.path[:0] = [{src!r}, {repo!r}]
from uruvbench import harness
for cell in {cells!r}:
    line = harness.run(Path({root!r}), cell, 3, 0.3, False, device="cpu")
    assert line["correct"], line
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax(tiny):
    out = subprocess.run(
        [sys.executable, "-c", RUN_AND_LIST.format(
            src=str(REPO / "src"), repo=str(REPO), root=str(tiny),
            cells=CELLS)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "uruvbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_blocked_modules_compares_whole_top_level_names():
    port = ["repro_torch", "repro_torch.api", "reprocess", "jaxtyping", "numpy"]
    assert harness.blocked_modules(port) == []
    assert harness.blocked_modules(port + ["repro.core.store", "jax.numpy",
                                           "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_the_command_refuses_without_a_card_or_a_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without")
    cmd = [sys.executable, "uruvbench/run.py", "--workload", CELLS[0],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 3 and out.stdout.strip() == ""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "uruvbench", tmp_path / "uruvbench")
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_on_the_card(tiny, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for trace in (False, True):
        line = harness.run(tiny, cell, SEED, 1.0, trace, device="cuda")
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["kernels_roofline"]["value"] <= 100


# ------------------------------------------------------- BENCHMARK.json
NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.-]{1,16}"


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_benchmark_json_meets_its_contract():
    import re

    b = BENCH
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["uruvbench"] and 1 <= b["run_seconds"] <= 51
    assert all(_line(w) for w in b["command"])
    names = {}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.fullmatch(NAME, c["name"]) and _line(c["source"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["file"].startswith("uruvbench/") and cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"]) <= set(cfg)
        names[c["name"]] = c
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.fullmatch(NAME, w["name"]) and re.fullmatch(NAME, w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
        assert (REPO / "uruvbench/traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == set(names)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.fullmatch(NAME, m["name"]) and re.fullmatch(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (REPO / "uruvbench/metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    reports = {c: {m["name"] for m in b["end_to_end"]
                   if c in m.get("workloads", CELLS)} for c in CELLS}
    for c in CELLS:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert any(c in m["workloads"] for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert all(m["moves"] in reports[c] for c in m["workloads"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in b[k]]
    assert len(all_names) == len(set(all_names))
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
