"""The traced run's device trace and the harness's own host spans.

``torch.profiler`` records device activity only (kernels, copies,
memsets): recording host ops too would slow the host and overstate the
idle share.  The harness marks what the host was doing with its own
spans (plan build, apply or dispatch, confirm, result slicing) on the
wall clock, and each idle gap of the device is put down to the span
that covers most of it.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10                  # entries of each breakdown list


class NoTrace:
    """What the loops call when the run is not traced."""

    active = False
    facts: Optional[dict] = None

    @contextlib.contextmanager
    def span(self, label: str):
        yield

    def due(self) -> bool:
        return False


class DeviceTrace(NoTrace):
    """Traces the first ``seconds`` of the window (the loops call
    :meth:`due` between plans and stop it then), writes the trace to
    ``path`` and reads it back."""

    def __init__(self, path: Path, seconds: float):
        self.path, self.seconds = Path(path), float(seconds)
        self.spans: List[Tuple[str, int, int]] = []
        self.prof = None

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        warnings.filterwarnings("ignore", message="Profiler clears events")
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.active = True
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()

    @contextlib.contextmanager
    def span(self, label: str):
        if not self.active:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((label, a, time.time_ns()))

    def due(self) -> bool:
        return self.active and time.perf_counter() - self.t0 >= self.seconds

    def stop(self) -> dict:
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        t1_ns = time.time_ns()
        self.active = False
        self.prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        trace = json.loads(self.path.read_text())
        self.facts = read_trace(trace, self.spans, self.t0_ns, t1_ns,
                                window_s)
        return self.facts


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_trace(trace: dict, spans: List[Tuple[str, int, int]], t0_ns: int,
               t1_ns: int, window_s: float) -> dict:
    """Device facts of one traced window: kernel and device-to-host copy
    counts, busy seconds (the union of every device op's interval), the
    ops that took most time, and the idle time put down to host spans."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = [e for e in trace.get("traceEvents", [])
              if e.get("cat") in DEVICE_CATS and "dur" in e]
    kernels = [e for e in events if e["cat"] == "kernel"]
    d2h = [e for e in events if e["cat"] == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    # event times in wall-clock ns, as the host spans are taken
    iv = _merge([(base + float(e["ts"]) * 1e3,
                  base + (float(e["ts"]) + float(e["dur"])) * 1e3)
                 for e in events])
    busy_ns = sum(b - a for a, b in iv)
    by_name: Dict[str, float] = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    aligned = bool(iv) and iv[0][0] >= t0_ns - 1e9 and iv[-1][1] <= t1_ns + 1e9
    gaps: List[Tuple[float, float]] = []
    if aligned:
        at = float(t0_ns)
        for a, b in iv + [(float(t1_ns), float(t1_ns))]:
            if a > at:
                gaps.append((at, min(a, t1_ns)))
            at = max(at, b)
    if not aligned and iv:
        print(f"uruvbench: device trace clock not aligned with the host's: "
              f"events {iv[0][0]:.0f}..{iv[-1][1]:.0f} ns, window "
              f"{t0_ns}..{t1_ns} ns", file=sys.stderr)
    idle = _label_gaps(gaps, spans) if aligned else {}
    return dict(kernels=len(kernels), d2h_copies=len(d2h),
                busy_s=busy_ns / 1e9, window_s=window_s,
                device_ops=[[n, s] for n, s in device_ops],
                idle_gaps=[[n, s] for n, s in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:TOP]])


def _label_gaps(gaps, spans) -> Dict[str, float]:
    """Seconds of device idle time under each host span label (``other``
    where no span covers a gap); a gap split between spans goes to each
    by its overlap."""
    out: Dict[str, float] = {}
    spans = sorted(spans, key=lambda s: s[1])
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(spans) and spans[j][2] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < b:
            ov = min(b, spans[k][2]) - max(a, spans[k][1])
            if ov > 0:
                out[spans[k][0]] = out.get(spans[k][0], 0.0) + ov / 1e9
                covered += ov
            k += 1
        rest = (b - a) - covered
        if rest > 0:
            out["other"] = out.get("other", 0.0) + rest / 1e9
    return out
