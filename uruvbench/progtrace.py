#!/usr/bin/env python3
"""The program's own spans in a traced run (``repro_torch.tracing``).

:class:`ProgramTrace` is a :class:`uruvbench.devtrace.DeviceTrace` that
also turns on the program's tracing for the traced seconds.  At its stop
it puts the program's records in ``facts["program"]``: self time by
layer, host reads, launches, queue waits, and how much of the harness's
calls into the program the program's spans cover.  It puts each idle gap
of the device down to the innermost span over it, the program's or the
harness's (``apply``, ``dispatch``, ``pump`` keep only what no program
span covers), and writes both sets of spans into the trace file as host
tracks beside the device's events.  Without a card (``device=False``)
only the program's part runs.  The metrics of :data:`PROGRAM_METRICS`
(``uruvbench/metrics/<name>.py``) read ``facts["program"]`` and read
nothing from a run without it.

The harness's traced run does not use this class yet.  Run a cell with
it, its metrics included in the line::

    python3 -m uruvbench.progtrace --workload paper-fig9b-w16k --seed 7 \
        --seconds 40

which also prints ``facts["program"]`` to standard error.
"""

from __future__ import annotations

import collections
import heapq
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

from uruvbench.devtrace import DEVICE_CATS, TOP, DeviceTrace, _merge

# self time of the spans whose names start so, by layer
LAYERS = {"frontend": ("serve.",), "api": ("api.",),
          "combining": ("batch.", "lifecycle."), "pages": ("pages",),
          "store": ("store.",), "sync": ("sync.",), "gc": ("python.gc",)}
# the harness's spans around calls into the program
CALLS = ("apply", "dispatch", "confirm", "replay", "pump")

_ALL = ["paper-fig9b-w16k", "serving-zipf-c4096",
        "paper-fig8c-w16k-pipelined"]
_SERVE = ["serving-zipf-c4096"]


def _metric(name, unit, source, layer, moves, cells):
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves, "workloads": cells}


_FRONT = "admission front end (serve.coalescer): "
_SYNC = "host reads of device values in every layer"
# the per_layer entries these metrics would take in BENCHMARK.json
PROGRAM_METRICS = [
    _metric("queue_wait_ms_p95", "ms", "program_span", _FRONT + "a request's "
            "wait from submit to its plan's dispatch", "op_latency_p95_ms",
            _SERVE),
    _metric("frontend_host_ms_per_plan", "ms/plan", "program_span",
            _FRONT + "self time of serve.* spans", "ops_per_s", _SERVE),
    _metric("api_host_ms_per_plan", "ms/plan", "program_span",
            "repro_torch.api (Uruv.apply, apply_nowait, confirm): self time "
            "of api.* spans", "ops_per_s", _ALL),
    _metric("combining_host_ms_per_plan", "ms/plan", "program_span",
            "combining and self-sizing (core.batch, core.lifecycle): self "
            "time of batch.* and lifecycle.* spans", "ops_per_s", _ALL),
    _metric("range_pages_ms_per_plan", "ms/plan", "program_span",
            "range path page materialisation (core.batch.bulk_range_all, "
            "api make_result): pages spans", "ops_per_s",
            ["paper-fig9b-w16k"]),
    _metric("store_host_ms_per_plan", "ms/plan", "program_span",
            "store pass (core.store): self time of store.* spans, the eager "
            "launches", "ops_per_s", _ALL),
    _metric("host_sync_ms_per_plan", "ms/plan", "program_span",
            _SYNC + ": sync.* spans", "ops_per_s", _ALL),
    _metric("host_syncs_per_plan", "syncs/plan", "program_counter",
            _SYNC + ": host_reads.* counters", "ops_per_s", _ALL),
]


def layer_of(name: str) -> str:
    for layer, prefixes in LAYERS.items():
        if name.startswith(prefixes):
            return layer
    return "other"


class ProgramTrace(DeviceTrace):
    """A device trace (``device=True``) or, without a card, the host's
    spans alone, with the program's tracing on while it is active."""

    def __init__(self, path, seconds: float, device: bool = True):
        super().__init__(path or ".", seconds)
        self.device = device

    def start(self) -> None:
        from repro_torch import tracing

        if self.device:
            super().start()
        else:
            self.active = True
            self.t0, self.t0_ns = time.perf_counter(), time.time_ns()
        tracing.enable()

    def stop(self) -> dict:
        from repro_torch import tracing

        tracing.disable()
        rec = tracing.take()
        if not self.device:
            self.active = False
            self.facts = {"window_s": time.perf_counter() - self.t0}
            gaps = []
        else:
            super().stop()
            trace = json.loads(self.path.read_text())
            gaps = _idle_gaps(trace, self.t0_ns, self.t0_ns
                              + int(self.facts["window_s"] * 1e9))
        prog = summarize(rec, self.spans, gaps)
        if self.device:
            prog["device_kernels"] = _custom_kernels(trace)
            self.facts["idle_gaps"] = prog["idle_gaps"]
            _write_host_tracks(self.path, trace, rec["spans"], self.spans)
        self.facts["program"] = prog
        print("uruvbench: program " + json.dumps(
            {k: v for k, v in prog.items() if k != "waits_s"}),
            file=sys.stderr, flush=True)
        return self.facts


def _idle_gaps(trace: dict, t0_ns: int, t1_ns: int) -> List[Tuple[float,
                                                                  float]]:
    """The window's device-idle intervals, wall-clock ns, as
    ``devtrace.read_trace`` finds them."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    iv = _merge([(base + float(e["ts"]) * 1e3,
                  base + (float(e["ts"]) + float(e["dur"])) * 1e3)
                 for e in trace.get("traceEvents", [])
                 if e.get("cat") in DEVICE_CATS and "dur" in e])
    gaps, at = [], float(t0_ns)
    for a, b in iv + [(float(t1_ns), float(t1_ns))]:
        if a > at:
            gaps.append((at, min(a, t1_ns)))
        at = max(at, b)
    return gaps


def _custom_kernels(trace: dict) -> Dict[str, int]:
    """Launches in the trace of each kernel outside PyTorch's own."""
    n = collections.Counter(
        e["name"] for e in trace.get("traceEvents", [])
        if e.get("cat") == "kernel" and "at::" not in e.get("name", ""))
    return dict(n.most_common(TOP))


def _depths(spans) -> List[int]:
    out: List[int] = []
    for s in spans:                  # a parent's record comes first
        out.append(1 if s[3] < 0 else out[s[3]] + 1)
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0.0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total


def _pieces(spans) -> List[Tuple[float, float, str]]:
    """The time ``spans`` (``(start, end, depth, label)``, nested or
    disjoint) cover as disjoint sorted pieces, each with the label of the
    innermost span over it."""
    events = sorted([(s[0], 1, k) for k, s in enumerate(spans)]
                    + [(s[1], 0, k) for k, s in enumerate(spans)])
    heap: list = []
    alive = set()
    pieces, prev = [], None
    for t, starts, k in events:
        if prev is not None and t > prev:
            while heap and heap[0][2] not in alive:
                heapq.heappop(heap)
            if heap:
                pieces.append((prev, t, spans[heap[0][2]][3]))
        if starts:
            alive.add(k)
            heapq.heappush(heap, (-spans[k][2], -spans[k][0], k))
        else:
            alive.discard(k)
        prev = t
    return pieces


def innermost_idle(gaps, spans) -> Dict[str, float]:
    """Seconds of ``gaps`` (sorted, disjoint) under the innermost of
    ``spans`` over each part, ``other`` where none is."""
    out: Dict[str, float] = collections.defaultdict(float)
    j = 0
    for a, b, label in _pieces(spans):
        while j < len(gaps) and gaps[j][1] <= a:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < b:
            out[label] += (min(b, gaps[k][1]) - max(a, gaps[k][0])) / 1e9
            k += 1
    rest = sum(b - a for a, b in gaps) / 1e9 - sum(out.values())
    if rest > 1e-12:
        out["other"] += rest
    return dict(out)


def summarize(rec: dict, harness_spans, gaps) -> dict:
    """``facts["program"]`` of one traced window from the program's
    records (``tracing.take()``), the harness's spans and the device's
    idle gaps."""
    from repro_torch import tracing

    spans = rec["spans"]
    self_s: Dict[str, float] = collections.defaultdict(float)
    for s, ns in zip(spans, tracing.self_ns(spans)):
        self_s[layer_of(s[0])] += ns / 1e9
    counters = rec["counters"]
    calls = _merge([(a, b) for label, a, b in harness_spans
                    if label in CALLS])
    prog = _merge([(a, b) for _, a, b, parent, _ in spans if parent < 0])
    depth = _depths(spans)
    labelled = [(a, b, 0, label) for label, a, b in harness_spans] + [
        (s[1], s[2], d, s[0]) for s, d in zip(spans, depth)]
    idle = innermost_idle(gaps, labelled)
    call_idle = _overlap(_merge(gaps), calls) / 1e9
    return {
        "self_s": dict(self_s),
        "spans": len(spans),
        "host_reads": sum(v for k, v in counters.items()
                          if k.startswith("host_reads.")),
        "host_reads_by_site": {k[len("host_reads."):]: v
                               for k, v in counters.items()
                               if k.startswith("host_reads.")},
        "launches": {k[len("launch."):]: v for k, v in counters.items()
                     if k.startswith("launch.")},
        "waits_s": rec["waits_s"],
        "call_s": sum(b - a for a, b in calls) / 1e9,
        "call_covered_s": _overlap(prog, calls) / 1e9,
        "call_idle_s": call_idle,
        "call_idle_unlabelled_s": sum(idle.get(c, 0.0) for c in CALLS),
        "idle_gaps": [[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def _write_host_tracks(path: Path, trace: dict, spans, harness_spans):
    """The program's and the harness's spans as two host tracks of the
    trace file."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    ev = trace.setdefault("traceEvents", [])
    for tid, name in ((1, "program spans"), (2, "harness spans")):
        ev.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": name}})
    for name, a, b, _, plan in spans:
        ev.append({"ph": "X", "cat": "program", "name": name, "pid": pid,
                   "tid": 1, "ts": (a - base) / 1e3, "dur": (b - a) / 1e3,
                   "args": {"plan": plan}})
    for name, a, b in harness_spans:
        ev.append({"ph": "X", "cat": "harness", "name": name, "pid": pid,
                   "tid": 2, "ts": (a - base) / 1e3, "dur": (b - a) / 1e3})
    Path(path).write_text(json.dumps(trace))


def program(facts: dict):
    """``facts["program"]`` with the plans it covers, or None."""
    p = (facts.get("trace") or {}).get("program")
    return p if p and facts.get("plans_traced") else None


def self_ms_per_plan(facts: dict, *layers: str):
    p = program(facts)
    if p is None:
        return None
    return 1e3 * sum(p["self_s"].get(x, 0.0) for x in layers) \
        / facts["plans_traced"]


def main() -> int:
    """``uruvbench/run.py`` with ``--trace 1``, its trace a
    :class:`ProgramTrace` and the cell's :data:`PROGRAM_METRICS` added."""
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    from uruvbench import harness
    from uruvbench import run

    load_cell = harness.load_cell

    def with_program_metrics(root_, name):
        cell = load_cell(root_, name)
        cell.per_layer += [m for m in PROGRAM_METRICS
                           if name in m["workloads"]]
        return cell

    harness.load_cell = with_program_metrics
    harness.DeviceTrace = ProgramTrace
    sys.argv += ["--trace", "1"]
    return run.main()


if __name__ == "__main__":
    sys.exit(main())
