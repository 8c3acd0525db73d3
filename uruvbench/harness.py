"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration file, its traffic file
(``uruvbench/traffic/<mix>.json``) and a reader a metric
(``uruvbench/metrics/<metric>.py``: ``read(facts)`` returns a number, or
None where the run has nothing to read).  A later cell, mix or metric is
new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from uruvbench import compare
from uruvbench.devtrace import DeviceTrace, NoTrace
from uruvbench.generator import Keyspace
from uruvbench.loops import LOOPS, prefill, young_gc_only
from uruvbench.reference import StoreMap

BLOCKED = ("jax", "jaxlib", "flax", "repro")   # top-level module names
TRACE_SECONDS = 5.0       # the traced run traces the window's first seconds
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "uruvbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _for(m, name)],
                [m for m in bench["per_layer"] if _for(m, name)])


def load_reader(root: Path, metric: str):
    path = root / "uruvbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"uruvbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def blocked_modules(names=None) -> List[str]:
    """The BLOCKED top-level names among ``names`` (default: every module
    this process has loaded), each name compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BLOCKED))


def _items_array(items) -> np.ndarray:
    flat = np.fromiter(itertools.chain.from_iterable(items), np.int64,
                       count=2 * len(items))
    return flat.reshape(-1, 2)


def device_facts(torch, device: str) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        *, device: str = "cuda", t_start: Optional[float] = None,
        log=lambda text: None) -> dict:
    """One run; returns the result line (a dict, ``checks`` last).
    ``log`` receives a few lines on where the run's time went."""
    t0 = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    cell = load_cell(root, workload)
    import torch
    from repro_torch import api

    cfg = cell.config
    keys = Keyspace(cfg, seed)
    db = api.Uruv(api.UruvConfig(**cfg["store"]), device=device,
                  policy=api.LifecyclePolicy(**cfg.get("lifecycle", {})))
    loop = LOOPS[cell.traffic["loop"]](db, api, cell.traffic, cfg, keys, seed)
    t_data = time.perf_counter()
    prefill(db, api, keys, loop.prefill_width)
    t_prefill = time.perf_counter()
    loop.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: to the data {t_data - t0:.3f}, prefill "
        f"{t_prefill - t_data:.3f}, warm-up {t0 + setup_s - t_prefill:.3f}")

    tr = NoTrace()
    if trace and device == "cuda":
        tr = DeviceTrace(HERE / ".traces" / f"{workload}.json",
                         min(TRACE_SECONDS, seconds))
        tr.start()
    with young_gc_only():
        facts = loop.run(seconds, tr)
    if device == "cuda":
        torch.cuda.synchronize()
    dev = device_facts(torch, device)

    lat = facts["latencies_s"]
    log(f"window: {facts['plans']} plans, {facts['ops_done']} ops done of "
        f"{facts['attempted']}, {facts['rejected']} rejected; first plans' "
        f"latency ms {[round(x * 1e3, 3) for x in facts['first_s']]}, "
        f"median {np.median(lat) * 1e3 if len(lat) else float('nan'):.3f}; "
        f"ops done an eighth of the window {facts['timeline']}; the store's "
        f"counters {dict((k, v) for k, v in facts['uruv'].items() if v)}")

    # the check: after the window and the memory reading, on the host
    t_check = time.perf_counter()
    items = _items_array(db.live_items())
    counts = {name: 0 for name in loop.checks}
    ref = StoreMap(keys.hi)
    ref.val[keys.prefill_keys] = keys.prefill_values
    ref.ts = len(keys.prefill_keys)
    loop.check(ref, counts)
    compare.check_live(ref, items, counts)
    log(f"check {time.perf_counter() - t_check:.3f} s over {len(items)} "
        "live items")

    facts.update(seconds=seconds, setup_s=setup_s, device=dev,
                 config=cfg, traffic=cell.traffic, trace=tr.facts)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = load_reader(root, m["name"])(facts)
        if v is None and not trace:
            raise RuntimeError(f"{m['name']}: the window completed no op")
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": all(v == 0 for v in counts.values()),
            "attempted": int(facts["attempted"]),
            "failed": compare.wrong_ops(counts),
            "metrics": metrics, "device": dev}
    if trace and tr.facts:
        dev.update(busy_s=tr.facts["busy_s"], window_s=tr.facts["window_s"])
        line["breakdown"] = {"device_ops": tr.facts["device_ops"],
                             "idle_gaps": tr.facts["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": compare.LIMITS[k]}
                      for k, v in counts.items()}
    return line


def checks_text(line: dict) -> List[str]:
    return [f"check {k}: {c['value']} (limit {c['limit']})"
            for k, c in line["checks"].items()]


