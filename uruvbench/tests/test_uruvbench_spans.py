"""The program's spans in a traced run (``uruvbench.progtrace``), on the
CPU at the tiny sizes of ``test_uruvbench_harness``: each cell's loop runs
under a :class:`ProgramTrace` without the device trace, and every metric
of ``PROGRAM_METRICS`` for the cell reads a finite number from it."""

import json

import numpy as np
import pytest
import torch

from uruvbench import harness, progtrace
from uruvbench.generator import Keyspace
from uruvbench.loops import LOOPS, prefill
from uruvbench.tests.test_uruvbench_harness import (
    CELLS, REPO, SEED, make_tiny_root, one_thread,  # noqa: F401 (fixture)
)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("uruvbench_spans"))


def traced_tiny(root, name, seconds=1.0):
    """One tiny window of cell ``name`` on the CPU, the program's tracing
    on for its first half; the loop's facts with ``trace``."""
    from repro_torch import api

    cell = harness.load_cell(root, name)
    cfg = cell.config
    keys = Keyspace(cfg, SEED)
    db = api.Uruv(api.UruvConfig(**cfg["store"]), device="cpu",
                  policy=api.LifecyclePolicy(**cfg.get("lifecycle", {})))
    loop = LOOPS[cell.traffic["loop"]](db, api, cell.traffic, cfg, keys,
                                       SEED)
    prefill(db, api, keys, loop.prefill_width)
    loop.warm()
    tr = progtrace.ProgramTrace(None, seconds / 2, device=False)
    tr.start()
    facts = loop.run(seconds, tr)
    facts["trace"] = tr.facts
    return facts


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_run_reports_each_program_metric(tiny, cell):
    facts = traced_tiny(tiny, cell)
    p = facts["trace"]["program"]
    assert facts["plans_traced"] > 0 and p["spans"] > 0
    names = [m["name"] for m in progtrace.PROGRAM_METRICS
             if cell in m["workloads"]]
    assert names
    got = {n: harness.load_reader(REPO, n)(facts) for n in names}
    for n, v in got.items():
        assert v is not None and np.isfinite(v) and v >= 0, (n, v)
    assert got["api_host_ms_per_plan"] > 0 and got["host_syncs_per_plan"] > 0
    if "range_pages_ms_per_plan" in got:
        assert got["range_pages_ms_per_plan"] > 0
    # self times partition the time program spans cover, inside the window
    assert 0 < sum(p["self_s"].values()) <= facts["trace"]["window_s"] + 1e-3
    assert p["call_covered_s"] <= p["call_s"] + 1e-9
    json.dumps({k: v for k, v in p.items() if k != "waits_s"})


def test_readers_read_nothing_without_the_programs_spans():
    facts = {"trace": None, "plans_traced": 4}
    device_only = {"trace": {"kernels": 10, "busy_s": 1.0},
                   "plans_traced": 4}
    for m in progtrace.PROGRAM_METRICS:
        read = harness.load_reader(REPO, m["name"])
        assert read(facts) is None and read(device_only) is None


def test_idle_gaps_go_to_the_innermost_span():
    s = 1e9
    spans = [(0, 100 * s, 0, "apply"), (10 * s, 90 * s, 1, "api.apply"),
             (20 * s, 50 * s, 2, "store.bulk_apply"),
             (40 * s, 50 * s, 3, "sync.store.precheck"),
             (200 * s, 210 * s, 0, "plan_build")]
    gaps = [(0, 5 * s), (15 * s, 45 * s), (60 * s, 95 * s),
            (150 * s, 205 * s)]
    got = progtrace.innermost_idle(gaps, spans)
    assert got == pytest.approx({"apply": 10, "api.apply": 35,
                                 "store.bulk_apply": 20,
                                 "sync.store.precheck": 5,
                                 "plan_build": 5, "other": 50})


def test_program_metrics_meet_the_per_layer_contract():
    """The entries are what BENCHMARK.json's per_layer takes, and any of
    them that BENCHMARK.json has is the same there."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    end_to_end = {m["name"] for m in bench["end_to_end"]}
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for m in progtrace.PROGRAM_METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert per_layer.get(m["name"], m) == m
        assert m["name"] not in end_to_end and set(m["workloads"]) <= cells
        assert (REPO / "uruvbench/metrics" / f"{m['name']}.py").is_file()
        assert len(m["layer"]) <= 200 and m["moves"] in end_to_end


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_program_traced_cells_on_the_card(tiny, monkeypatch, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    load_cell = harness.load_cell

    def with_metrics(root, name):
        c = load_cell(root, name)
        c.per_layer += [m for m in progtrace.PROGRAM_METRICS
                        if name in m["workloads"]]
        return c
    monkeypatch.setattr(harness, "load_cell", with_metrics)
    monkeypatch.setattr(harness, "DeviceTrace", progtrace.ProgramTrace)
    line = harness.run(tiny, cell, SEED, 1.0, True, device="cuda")
    assert line["correct"], line["checks"]
    for m in progtrace.PROGRAM_METRICS:
        if cell in m["workloads"]:
            assert np.isfinite(line["metrics"][m["name"]]["value"]), m
    labels = {n for n, _ in line["breakdown"]["idle_gaps"]}
    assert labels & {"api.apply", "api.apply_nowait", "api.confirm",
                     "serve.pump", "serve.dispatch", "store.bulk_apply"}
    trace = json.loads((harness.HERE / ".traces"
                        / f"{cell}.json").read_text())
    assert any(e.get("cat") == "program" for e in trace["traceEvents"])
