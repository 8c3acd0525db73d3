#!/usr/bin/env python3
"""chip_smoke.py — drive the PyTorch port of Uruv on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (one card, ~minutes)
    python3 chip_smoke.py --prefill 20000 --plans 2 --reduced 5000   # short

Phases, one line each (any failure exits non-zero):

  1. probe     torch / CUDA / nvcc versions, the card's name and power limit
  2. build     the CUDA kernels, from ``src/repro_torch/csrc``, in parallel
  3. parity    each kernel against its plain PyTorch twin on edge cases
               (the KEY_MAX - 1 pad query, cyclic chains, inverted
               intervals, pvalid=False slots): exact equality
  4. main      the single-device CRUD + range path through ``Uruv.apply``:
               prefill ``--prefill`` distinct keys of a 2,000,000-key
               universe in plans of 4096, then ``--plans`` mixed plans of
               the paper's fig9b mix (90% search, 5% update, 5% range of
               size 1000) plus ranges and lookups under a held snapshot;
               every result is checked against a host-side oracle, then
               ``check_invariants`` and ``live_items``
  4b. profile two more fig9b plans under ``torch.profiler`` (device
               activity): wall time, device busy time, idle share,
               kernels and device-to-host copies per plan, top kernels
  5. cpu==cuda the same seeded plans at ``--reduced`` keys on ``cuda`` and
               on ``device="cpu"``: the two stores must be bit-equal
  6. kernels   each kernel again at the inputs the main path gave it: exact
               parity, its time, its plain twin's time, its bound

The line before the last is the JSON ``kernels`` report; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing any result.
It imports nothing of JAX and nothing of the JAX package: the oracle is
written here.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

UNIVERSE = 2_000_000
WIDTH = 4096
RANGE_SIZE = 1000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM published HBM3 bandwidth
INT32_OPS_PER_S = 67e12       # published non-tensor 32-bit rate (fp32 figure)
MAIN_CFG = dict(leaf_cap=64, max_leaves=1 << 17, max_versions=1 << 22,
                tracker_cap=128, max_chain=64, index_fanout=16)
REDUCED_CFG = dict(leaf_cap=64, max_leaves=1 << 12, max_versions=1 << 18,
                   tracker_cap=128, max_chain=64, index_fanout=16)
KERNELS = {   # name -> (CUDA source, the TPU kernel it replaces)
    "index_descend": ("src/repro_torch/csrc/uruv_search.cu",
                      "src/repro/kernels/uruv_search/uruv_search.py:126"),
    "leaf_slots": ("src/repro_torch/csrc/uruv_search.cu",
                   "src/repro/kernels/uruv_search/uruv_search.py:172"),
    "versioned_read": ("src/repro_torch/csrc/versioned_read.cu",
                       "src/repro/kernels/versioned_read/versioned_read.py:52"),
    "range_scan": ("src/repro_torch/csrc/uruv_range.cu",
                   "src/repro/kernels/uruv_range/uruv_range.py:82"),
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def same(a, b) -> bool:
    return bool(torch.equal(a.cpu(), b.cpu()))


def max_abs_err(outs, refs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(outs, refs))


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1-2: probe + build
# ---------------------------------------------------------------------------

def probe() -> str:
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say("probe", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=(nvcc.stdout.strip().splitlines() or ["?"])[-1].replace(" ", "_"),
        device=repr(torch.cuda.get_device_name(0)),
        capability=torch.cuda.get_device_capability(0))
    print(card, flush=True)
    return card


# ---------------------------------------------------------------------------
# phase 3: kernel parity on edge cases
# ---------------------------------------------------------------------------

def parity_edge_cases(rng, dev) -> None:
    from repro_torch.core import index as I
    from repro_torch.core.ref import KEY_MAX, KEY_MIN
    from repro_torch.kernels.uruv_range.ref import range_scan_ref
    from repro_torch.kernels.uruv_range.uruv_range import range_scan
    from repro_torch.kernels.uruv_search.ref import (
        index_descend_ref, leaf_slots_ref)
    from repro_torch.kernels.uruv_search.uruv_search import (
        index_descend, leaf_slots)
    from repro_torch.kernels.versioned_read.ref import versioned_read_ref
    from repro_torch.kernels.versioned_read.versioned_read import (
        versioned_read)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    n_cases = 0
    for fanout, n_sep in ((4, 300), (16, 3000), (16, 1)):
        ML = 4096
        seps = np.sort(rng.choice(10**7, n_sep, replace=False)).astype(np.int32)
        seps[0] = KEY_MIN
        pk = np.full(ML, KEY_MAX, np.int32)
        pk[:n_sep] = seps
        pl = np.full(ML, -1, np.int32)
        pl[:n_sep] = rng.permutation(ML)[:n_sep]
        idx = I.build(I.index_config(ML, fanout), ML, t(pk), t(pl), n_sep)
        q = t(np.concatenate([
            rng.integers(-10, 10**7 + 10, 5000), seps, seps + 1,
            [KEY_MAX - 1, KEY_MAX, KEY_MIN, KEY_MIN + 1]]).astype(np.int32))
        got = index_descend(idx.node_keys, idx.node_child, q)
        want = index_descend_ref(idx.node_keys, idx.node_child, q)
        check(all(same(a, b) for a, b in zip(got, want)),
              f"index_descend != plain (F={fanout}, n_sep={n_sep})")
        n_cases += 1

    for P, L in ((5000, 64), (777, 8), (1000, 33)):
        rows = np.sort(rng.integers(0, 5000, (P, L)), axis=1).astype(np.int32)
        rows[rng.random((P, L)) < 0.1] = KEY_MAX
        rows = np.sort(rows, axis=1)
        q = rng.integers(0, 5100, P).astype(np.int32)
        q[:7] = KEY_MAX - 1
        got = leaf_slots(t(rows), t(q))
        want = leaf_slots_ref(t(rows), t(q))
        check(all(same(a, b) for a, b in zip(got, want)),
              f"leaf_slots != plain (P={P}, L={L})")
        n_cases += 1

    for MV, P, chain in ((128, 5000, 4), (100_000, 20_000, 64)):
        ts = t(rng.integers(0, 50, MV))
        nxt = t(rng.integers(-1, MV, MV))          # random chains: cycles
        val = t(rng.integers(-2, 99, MV))
        val[::17] = -(2**31) + 1                   # tombstones
        vh = t(rng.integers(-1, MV, P))
        snap = t(rng.integers(-5, 50, P))
        got = versioned_read(vh, snap, ts, nxt, val, max_chain=chain)
        want = versioned_read_ref(vh, snap, ts, nxt, val, max_chain=chain)
        check(same(got, want), f"versioned_read != plain (MV={MV}, "
                               f"chain={chain})")
        n_cases += 1

    for Q, S, ML, L, MV, chain in ((300, 3, 64, 8, 512, 16),
                                   (4096, 1, 2048, 64, 50_000, 64)):
        lkeys = t(np.sort(rng.integers(0, 10_000, (ML, L)), axis=1))
        lvh = t(rng.integers(-1, MV, (ML, L)))
        lcnt = t(rng.integers(0, L + 1, ML))
        vts = t(rng.integers(0, 60, MV))
        vnxt = t(rng.integers(-1, MV, MV))
        vval = t(rng.integers(-2, 99, MV))
        lids = t(rng.integers(0, ML, (Q, S)))
        pvalid = t(rng.random((Q, S)) < 0.8, torch.bool)
        k1 = t(rng.integers(0, 10_000, Q))
        k2 = t(np.asarray(k1.cpu()) + rng.integers(-500, 3000, Q))  # inverted too
        snap = t(rng.integers(0, 60, Q))
        args = (lids, pvalid, k1, k2, snap, lkeys, lvh, lcnt, vts, vnxt, vval)
        got = range_scan(*args, max_chain=chain)
        want = range_scan_ref(*args, max_chain=chain)
        check(all(same(a, b) for a, b in zip(got, want)),
              f"range_scan != plain (Q={Q}, S={S}, L={L})")
        n_cases += 1
    torch.cuda.synchronize()
    say("parity", cases=n_cases, result="exact")


# ---------------------------------------------------------------------------
# phase 4: the main path, checked against a host-side oracle
# ---------------------------------------------------------------------------

class Oracle:
    """Dense host oracle over the key universe: value or NOT_FOUND."""

    def __init__(self, not_found: int, tombstone: int):
        self.nf = not_found
        self.tomb = tombstone
        self.val = np.full(UNIVERSE, not_found, np.int64)

    def crud(self, codes, keys, values, op):
        """Sequential semantics of one CRUD run; returns per-op results."""
        out = np.empty(len(codes), np.int64)
        val = self.val
        for i, (c, k, v) in enumerate(zip(codes.tolist(), keys.tolist(),
                                          values.tolist())):
            out[i] = val[k]
            if c == op["insert"]:
                val[k] = v
            elif c == op["delete"]:
                val[k] = self.nf
        return out

    def range(self, k1: int, k2: int, val=None):
        val = self.val if val is None else val
        ks = np.nonzero(val[k1:k2 + 1] != self.nf)[0] + k1
        return np.stack([ks, val[ks]], 1) if len(ks) else np.zeros((0, 2))


def mixed_plan(rng, api):
    """One fig9b plan of WIDTH ops: CRUD ops in random order, the range
    ops (5%) after them — one CRUD segment and one RANGE segment."""
    n_range = round(WIDTH * 0.05)
    n_crud = WIDTH - n_range
    r = rng.random(n_crud) * 0.95
    keys = rng.integers(0, UNIVERSE, n_crud).astype(np.int32)
    is_upd = r >= 0.90
    is_del = is_upd & (rng.random(n_crud) < 0.5)
    codes = np.where(is_del, api.OP_DELETE,
                     np.where(is_upd, api.OP_INSERT, api.OP_SEARCH))
    vals = np.where(is_upd & ~is_del, rng.integers(1, 1 << 20, n_crud), 0)
    lo = rng.integers(0, UNIVERSE - RANGE_SIZE, n_range).astype(np.int32)
    crud = api.OpBatch(codes.astype(np.int32), keys, vals.astype(np.int32))
    return api.OpBatch.concat(crud, api.OpBatch.ranges(lo, lo + RANGE_SIZE - 1))


def run_plans(db, api, rng, oracle, n_keys: int, n_plans: int, *,
              verify: bool, tag: str):
    """Prefill ``n_keys`` distinct keys, then ``n_plans`` mixed plans with
    a held snapshot in the middle.  Returns timing facts."""
    op = dict(insert=api.OP_INSERT, delete=api.OP_DELETE)
    keys = rng.choice(UNIVERSE, n_keys, replace=False).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, n_keys, WIDTH):
        k = keys[i:i + WIDTH]
        res = db.apply(api.OpBatch.inserts(k, k % 1000 + 1))
        if verify:
            check(np.all(res.values == api.NOT_FOUND),
                  f"{tag}: prefill insert saw a previous value")
            oracle.val[k] = k % 1000 + 1
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    apply_s = 0.0
    n_ops = 0
    held = held_val = None
    for p in range(n_plans):
        if p == n_plans // 2:
            held = db.acquire_snapshot()
            held_val = oracle.val.copy() if verify else None
        plan = mixed_plan(rng, api)
        base = db.ts
        t0 = time.perf_counter()
        res = db.apply(plan)
        apply_s += time.perf_counter() - t0
        n_ops += len(plan)
        if not verify:
            continue
        check(np.array_equal(res.timestamps, base + np.arange(len(plan))),
              f"{tag}: timestamps")
        crud = plan.codes != api.OP_RANGE
        want = oracle.crud(plan.codes[crud], plan.keys[crud],
                           plan.values[crud], op)
        check(np.array_equal(res.values[crud], want),
              f"{tag}: plan {p} CRUD results differ from the oracle")
        for pos in plan.range_positions.tolist():
            page = np.asarray(res.page(pos), np.int64).reshape(-1, 2)
            exp = oracle.range(int(plan.keys[pos]), int(plan.values[pos]))
            check(np.array_equal(page, exp) and res.values[pos] == len(exp),
                  f"{tag}: plan {p} RANGE page at {pos} differs")
    if held is not None:
        lo = rng.integers(0, UNIVERSE - RANGE_SIZE, 64).astype(np.int32)
        pages = db.range_all(lo, lo + RANGE_SIZE - 1, held)
        probe_keys = rng.integers(0, UNIVERSE, WIDTH).astype(np.int32)
        got = db.lookup(probe_keys, held)
        db.release_snapshot(held)
        if verify:
            for a, pg in zip(lo.tolist(), pages):
                exp = oracle.range(a, a + RANGE_SIZE - 1, held_val)
                check(np.array_equal(np.asarray(pg, np.int64).reshape(-1, 2),
                                     exp), f"{tag}: held-snapshot range")
            check(np.array_equal(got, held_val[probe_keys]),
                  f"{tag}: held-snapshot lookup")
    return dict(prefill_s=prefill_s, apply_s=apply_s, n_ops=n_ops)


class Recorder:
    """Keeps, per kernel, the inputs of the widest call the main path made
    (wrapping the names ``repro_torch.core.backend`` calls)."""

    NAMES = {"index_descend": "index_descend", "leaf_slots": "leaf_slots",
             "versioned_read": "versioned_read", "range_scan": "_range_scan"}

    def __init__(self, backend):
        self.backend = backend
        self.calls = {}
        self.orig = {k: getattr(backend, v) for k, v in self.NAMES.items()}

    def __enter__(self):
        for k, v in self.NAMES.items():
            setattr(self.backend, v, self._wrap(k, self.orig[k]))
        return self

    def __exit__(self, *exc):
        for k, v in self.NAMES.items():
            setattr(self.backend, v, self.orig[k])

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            width = args[2].numel() if name == "index_descend" \
                else args[0].numel()
            if width >= self.calls.get(name, (0,))[0]:
                self.calls[name] = (width, args, kw)
            return fn(*args, **kw)
        return rec


def main_path(args, api, rng) -> dict:
    from repro_torch.core import backend, store as S
    from repro_torch.kernels import _build

    cfg = api.UruvConfig(**MAIN_CFG)
    torch.cuda.reset_peak_memory_stats()
    db = api.Uruv(cfg)
    pool_mib = store_mib(db.store)
    oracle = Oracle(api.NOT_FOUND, api.TOMBSTONE)
    _build.launch_counts.clear()
    with Recorder(backend) as rec:
        facts = run_plans(db, api, rng, oracle, args.prefill, args.plans,
                          verify=True, tag="main")
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    S.check_invariants(db.store)
    live = np.asarray(db.live_items(), np.int64).reshape(-1, 2)
    ks = np.nonzero(oracle.val != api.NOT_FOUND)[0]
    check(np.array_equal(live, np.stack([ks, oracle.val[ks]], 1)),
          "main: live_items differs from the oracle")
    stats = db.stats
    say("main", keys=args.prefill, plans=args.plans,
        prefill_s=f"{facts['prefill_s']:.3f}",
        mixed_ops_per_s=f"{facts['n_ops'] / max(facts['apply_s'], 1e-9):.1f}",
        slow_path_rounds=stats["slow_path_rounds"],
        device_passes=stats["device_passes"],
        n_leaves=int(db.store.n_leaves), pools_mib=f"{pool_mib:.1f}",
        max_memory_allocated_mib=(
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f}"),
        launches=json.dumps(counts, sort_keys=True).replace(" ", ""))
    for name in KERNELS:
        check(counts.get(name, 0) > 0, f"kernel {name} never ran on the "
                                       "main path")
    return dict(counts=counts, calls=rec.calls, store=db.store, facts=facts,
                stats=stats, db=db)


# ---------------------------------------------------------------------------
# phase 4b: where a mixed plan's time goes (torch.profiler trace)
# ---------------------------------------------------------------------------

def profile_plans(db, api, rng, n_plans: int = 2) -> dict:
    """Trace ``n_plans`` more fig9b plans on the main path's store and
    read the trace: wall time, device busy time (union of kernel
    intervals), kernel launches, device-to-host copies (host syncs) and
    the kernels that take the most device time."""
    plans = [mixed_plan(rng, api) for _ in range(n_plans)]
    torch.cuda.synchronize()
    # device activity only: host-side op recording would slow the host
    # and overstate the idle share
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for plan in plans:
            db.apply(plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    d2h = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kern)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    check(kern, "profile: the trace holds no kernel on the card")
    out = dict(plans=n_plans, wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
               idle_share=1 - busy_us / 1e3 / wall_ms,
               kernels_per_plan=len(kern) / n_plans,
               d2h_copies_per_plan=len(d2h) / n_plans)
    say("profile", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                      for k, v in out.items()},
        top_kernels_ms=json.dumps({n[:40]: round(us / 1e3, 4)
                                   for n, us in top}).replace(" ", ""))
    return out


# ---------------------------------------------------------------------------
# phase 5: the same plans on cuda and on the CPU -> bit-equal stores
# ---------------------------------------------------------------------------

def cpu_equals_cuda(args, api) -> None:
    from repro_torch.core import store as S

    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(args.seed + 1)
        db = api.Uruv(api.UruvConfig(**REDUCED_CFG), device=dev)
        oracle = Oracle(api.NOT_FOUND, api.TOMBSTONE)
        run_plans(db, api, rng, oracle, args.reduced, 4, verify=False,
                  tag=dev)
        n_live = db.compact()
        db.reindex()
        out[dev] = (S.to_numpy(db.store), n_live, db.stats)
    a, b = out["cuda"][0], out["cpu"][0]
    check(sorted(a) == sorted(b), "cpu/cuda store fields differ")
    for name in a:
        check(a[name].dtype == b[name].dtype
              and np.array_equal(a[name], b[name]),
              f"cpu/cuda store differ in {name}")
    check(out["cuda"][1:] == out["cpu"][1:], "cpu/cuda stats differ")
    say("cpu==cuda", keys=args.reduced, fields=len(a),
        live_keys=out["cuda"][1], result="bit-equal")


# ---------------------------------------------------------------------------
# phase 6: kernels at the main path's inputs — parity, time, bound
# ---------------------------------------------------------------------------

def store_mib(store) -> float:
    """Device memory held by a store's tensors, MiB."""
    ix = store.index
    ts = [v for v in vars(store).values() if torch.is_tensor(v)]
    ts += [v for v in vars(ix).values() if torch.is_tensor(v)]
    ts += [t for f in ("node_keys", "node_child", "node_cnt")
           for t in getattr(ix, f)]
    return sum(t.numel() * t.element_size() for t in ts) / 2**20


def _unique(x: torch.Tensor) -> int:
    return int(torch.unique(x).numel())


def _descent_touch(level_keys, level_child, q, key_max):
    """(distinct node rows, distinct child entries) the descent reads."""
    F = level_keys[0].shape[1]
    cur = torch.zeros_like(q)
    rows = ents = 0
    for l in range(len(level_keys) - 1, -1, -1):
        r = cur.clamp(0, level_keys[l].shape[0] - 1).long()
        k = level_keys[l][r]
        slot = (((k <= q[:, None]) & (k < key_max)).sum(1) - 1).clamp_min(0)
        rows += _unique(r)
        ents += _unique(r * F + slot)
        cur = level_child[l][r, slot]
    return rows, ents


def _chain_touch(vhead, snap, ver_ts, ver_next, max_chain):
    """Distinct version entries whose ts, next and value the bounded walk
    must read, for these chains at these snapshots."""
    n = ver_ts.shape[0]
    cur = vhead.long()
    seen_ts, seen_next = [], []
    for _ in range(max_chain):
        live = cur >= 0
        c = cur.clamp(0, n - 1)
        adv = live & (ver_ts[c] > snap)
        seen_ts.append(c[live])
        seen_next.append(c[adv])
        if not bool(adv.any()):
            break
        cur = torch.where(adv, ver_next[c].long(), cur)
    c = cur.clamp(0, n - 1)
    final = c[(cur >= 0) & (ver_ts[c] <= snap)]
    return (_unique(torch.cat(seen_ts)), _unique(torch.cat(seen_next)),
            _unique(final))


def kernel_report(main) -> list:
    from repro_torch.core.ref import KEY_MAX
    from repro_torch.kernels.uruv_range.ref import range_scan_ref
    from repro_torch.kernels.uruv_range.uruv_range import range_scan
    from repro_torch.kernels.uruv_search.ref import (
        index_descend_ref, leaf_slots_ref)
    from repro_torch.kernels.uruv_search.uruv_search import (
        index_descend, leaf_slots)
    from repro_torch.kernels.versioned_read.ref import versioned_read_ref
    from repro_torch.kernels.versioned_read.versioned_read import (
        versioned_read)

    kern = {"index_descend": (index_descend, index_descend_ref),
            "leaf_slots": (leaf_slots, leaf_slots_ref),
            "versioned_read": (versioned_read, versioned_read_ref),
            "range_scan": (range_scan, range_scan_ref)}
    rows = []
    for name, (fn, ref) in kern.items():
        _, a, kw = main["calls"][name]
        outs = fn(*a, **kw)
        refs = ref(*a, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        check(all(same(x, y) for x, y in zip(outs, refs)),
              f"{name} != plain at the main path's inputs")
        err = max_abs_err(outs, refs)
        ms = time_ms(lambda: fn(*a, **kw))
        plain_ms = time_ms(lambda: ref(*a, **kw), iters=5)
        library_ms = None
        if name == "index_descend":
            keys, child, q = a
            P, F = q.numel(), keys[0].shape[1]
            n_rows, n_ents = _descent_touch(keys, child, q, KEY_MAX)
            nbytes = 4 * P + 3 * 4 * P + n_rows * F * 4 + n_ents * 4
            nops = 2 * P * len(keys) * F
            shape = f"P={P},D={len(keys)},F={F}"
        elif name == "leaf_slots":
            r, q = a
            P, L = r.shape
            nbytes = 4 * P * L + 4 * P + 4 * P + P
            nops = P * L
            library_ms = time_ms(
                lambda: torch.searchsorted(r, q[:, None]))
            shape = f"P={P},L={L}"
        elif name == "versioned_read":
            vh, sn, vts, vnx, vval = a
            n_ts, n_next, n_val = _chain_touch(vh, sn, vts, vnx,
                                               kw["max_chain"])
            P = vh.numel()
            nbytes = 8 * P + 4 * P + 4 * (n_ts + n_next + n_val)
            nops = 2 * (n_ts + P)
            shape = f"P={P},MV={vts.numel()}"
        else:
            (lids, pv, k1, k2, sn, lk, lvh, lc, vts, vnx, vval) = a
            Q, S = lids.shape
            L = lk.shape[1]
            live_lids = lids[pv]
            n_leaf = _unique(live_lids)
            cand_vh = torch.where(pv[:, :, None] & (
                torch.arange(L, device=lk.device) < lc[lids][..., None]) & (
                lk[lids] >= k1[:, None, None]) & (lk[lids] <= k2[:, None, None]),
                lvh[lids], -1).reshape(-1)
            cand = cand_vh >= 0
            snap_c = sn[:, None, None].expand(Q, S, L).reshape(-1)
            n_ts, n_next, n_val = _chain_touch(cand_vh[cand], snap_c[cand],
                                               vts, vnx, kw["max_chain"])
            nbytes = (Q * S * 5 + Q * 12 + n_leaf * (L * 4 + 4)
                      + 4 * int(cand.sum()) + 4 * (n_ts + n_next + n_val)
                      + 2 * 4 * Q * S * L)
            nops = Q * S * L * 4
            shape = f"Q={Q},S={S},L={L}"
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = nops / INT32_OPS_PER_S * 1e3
        src, replaces = KERNELS[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=main["counts"].get(name, 0), max_abs_err=err,
            ms=ms, plain_ms=plain_ms,
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            library_ms=library_ms))
        say("kernel", name=name, shape=shape, ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}",
            bound_ms=f"{max(bound_bytes, bound_ops):.6f}",
            library_ms=library_ms if library_ms is None
            else f"{library_ms:.5f}", max_abs_err=err)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill", type=int, default=1_000_000)
    ap.add_argument("--plans", type=int, default=16)
    ap.add_argument("--reduced", type=int, default=50_000)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.api as api
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    card = probe()
    secs = _build.build()
    say("build", seconds=f"{max(secs.values()):.2f}",
        libraries=len(secs), dir=str(_build.BUILD_DIR))
    rng = np.random.default_rng(args.seed)
    parity_edge_cases(rng, torch.device("cuda"))
    main_res = main_path(args, api, rng)
    profile_plans(main_res.pop("db"), api, rng)
    cpu_equals_cuda(args, api)
    rows = kernel_report(main_res)
    say("done", seconds=f"{time.perf_counter() - t_all:.1f}", card=repr(card))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
