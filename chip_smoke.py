#!/usr/bin/env python3
"""chip_smoke.py — drive the PyTorch port of Uruv on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (one card, ~minutes)
    python3 chip_smoke.py --prefill 20000 --plans 2 --reduced 5000  # short
    python3 chip_smoke.py --durable-worker DIR --crash SEL --keys N  # phase 9's worker

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
  6. lifecycle a self-sizing ``Uruv(leaf_cap=16, max_leaves=32,
               max_versions=4096)`` on cuda taken far past its pools with
               inserts, deletes and a held snapshot: every answer against
               the oracle, ``grows`` > 0 and ``maintain_passes`` > 0
  7. serve     ``repro_torch.launch.serve``'s engine on cuda: llama3.2-1b at
               full width (seeded random weights), 4 slots, max_len 512, a
               wave of 4 requests (a shared 256-token system prompt + 32-64
               own tokens, 32 new tokens each) and a wave of 4 follow-up
               turns plus one fresh system-prompt request; the first
               request goes through the flash prefill, the rest reuse a
               cached prefix (KV copy + step-by-step decode).  Every
               prefix-table answer against a host dict, prefix reuse >= 256
               in the first wave's others and the follow-ups, the fresh
               request's reuse printed (ROADMAP Queue 3 item 1), the launch
               counts of all six kernels, the snapshot released
  8. cpu==cuda model  llama3.2-1b at full width with 2 layers, the same
               weights on the CPU and on cuda: prefill + 8 teacher-forced
               decode steps; fp32 logits within atol = rtol = 1e-4, and
               the bf16 logits no further from the CPU's fp32 logits than
               twice as far as the CPU's own bf16 logits are
  9. durability the main configuration as a durable client
               (``durable_dir``, ``group_commit=8``): prefill, a full
               ``checkpoint()``, ``--plans`` fig9b plans, a delta
               checkpoint, half as many more plans (the WAL tail); then
               ``Uruv.recover`` on the card must give the live store bit
               for bit (the clock, every array, a held snapshot's pages
               and lookups) after replaying exactly the tail; then two
               worker processes (this script with ``--durable-worker``,
               importing only ``repro_torch``) are killed by
               ``wal.mid_append`` and ``ckpt.renamed:2`` crash points and
               each directory recovers to a prefix that covers every plan
               the worker acknowledged and equals a host replay of it
 10. kernels   each kernel again at the widest inputs its path gave it:
               parity with its twin (exact for the int32 store kernels;
               attention within one bf16 ulp, atol 1e-5 + rtol 2^-7, in
               bf16 and within 2e-5 in fp32), its time, its plain twin's
               time, its bound and the PyTorch library call's time.
               ``search_positions`` (the flat-directory rank, which no path
               of either package calls) runs through its kernel-level
               entry on the main store's directory, as it stands and
               padded to ``max_leaves``, with one fig9b plan's keys, and
               must equal its twin, ``torch.searchsorted`` and the rank
               of the multi-level index that replaced the flat directory

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
BF16_TC_FLOPS = 989e12        # published dense bf16 tensor-core rate
SYSTEM_PROMPT = 256           # serve phase: shared prompt prefix, tokens
FP32_TOL = 1e-4               # model phase: fp32 logits, CPU vs card
BF16_SPREAD = 2.0             # model phase: card/CPU distance of bf16 to fp32
BF16_ULP = 2.0 ** -7          # attention: one bf16 ulp, relative, at worst
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
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:105"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:86"),
    "search_positions": ("src/repro_torch/csrc/uruv_search.cu",
                         "src/repro/kernels/uruv_search/uruv_search.py:60"),
}
STORE_KERNELS = ("index_descend", "leaf_slots", "versioned_read",
                 "range_scan")
SERVE_KERNELS = STORE_KERNELS + ("flash_attention", "decode_attention")
DURABLE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_durable"
WORKER_CKPT_EVERY = 2         # durability workers: a checkpoint every 2 plans
WORKER_MIXED = 4              # ... and 4 fig9b plans after their prefill


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
        index_descend_ref, leaf_slots_ref, search_positions_ref)
    from repro_torch.kernels.uruv_search.uruv_search import (
        index_descend, leaf_slots, search_positions)
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
    # flat-directory rank: empty, one-entry, ragged and KEY_MAX-padded
    # sorted directories; queries below dir[0], on every entry, and up to
    # KEY_MAX - 2 (the valid key domain)
    for n_dir, n_pad in ((0, 0), (1, 0), (1000, 0), (777, 300), (5, 1 << 17)):
        d = np.sort(rng.choice(10**7, n_dir, replace=False)).astype(np.int32)
        d = np.concatenate([d, np.full(n_pad, KEY_MAX, np.int32)])
        q = np.concatenate([rng.integers(-10, 10**7 + 10, 3000), d[:n_dir],
                            d[:n_dir] - 1, [KEY_MIN, KEY_MAX - 2]])
        q = t(q.astype(np.int32))
        got = search_positions(t(d), q)
        check(same(got, search_positions_ref(t(d), q)),
              f"search_positions != plain (n_dir={n_dir}, pad={n_pad})")
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


def verify_plan(oracle, api, plan, res, tag: str) -> None:
    """One fig9b plan's results against the host oracle (which it
    advances): CRUD values, then every RANGE page and its count."""
    op = dict(insert=api.OP_INSERT, delete=api.OP_DELETE)
    crud = plan.codes != api.OP_RANGE
    want = oracle.crud(plan.codes[crud], plan.keys[crud], plan.values[crud],
                       op)
    check(np.array_equal(res.values[crud], want),
          f"{tag}: CRUD results differ from the oracle")
    for pos in plan.range_positions.tolist():
        page = np.asarray(res.page(pos), np.int64).reshape(-1, 2)
        exp = oracle.range(int(plan.keys[pos]), int(plan.values[pos]))
        check(np.array_equal(page, exp) and res.values[pos] == len(exp),
              f"{tag}: RANGE page at {pos} differs")


def run_plans(db, api, rng, oracle, n_keys: int, n_plans: int, *,
              verify: bool, tag: str):
    """Prefill ``n_keys`` distinct keys, then ``n_plans`` mixed plans with
    a held snapshot in the middle.  Returns timing facts."""
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
        verify_plan(oracle, api, plan, res, f"{tag}: plan {p}")
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
        device_passes=stats["device_passes"], grows=stats["grows"],
        maintain_passes=stats["maintain_passes"],
        n_leaves=int(db.store.n_leaves), pools_mib=f"{pool_mib:.1f}",
        max_memory_allocated_mib=(
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f}"),
        launches=json.dumps(counts, sort_keys=True).replace(" ", ""))
    for name in STORE_KERNELS:
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


def search_positions_report(main, api, rng) -> list:
    """The flat-directory rank on the main store's directory (length
    ``n_leaves``) and on that directory padded with KEY_MAX to
    ``max_leaves``, as the TPU wrapper pads, for the keys of one fig9b
    plan.  No path of either package calls it (the multi-level index
    replaced the flat directory), so its path here is its kernel-level
    entry: the counts are set to 0 just before the two calls and read
    just after.  Then each result is held against the twin,
    ``torch.searchsorted`` (its library time) and ``max(rank_right - 1,
    0)`` of the store's multi-level index: exact."""
    from repro_torch.core import index as I
    from repro_torch.core import store as S
    from repro_torch.core.ref import KEY_MAX
    from repro_torch.kernels import _build
    from repro_torch.kernels.uruv_search.ref import search_positions_ref
    from repro_torch.kernels.uruv_search.uruv_search import search_positions

    store = main["store"]
    dev = store.device
    seps, _ = S.directory(store)
    ML = store.cfg.max_leaves
    padded = np.full(ML, KEY_MAX, np.int32)
    padded[:len(seps)] = seps
    dirs = {"n_leaves": torch.as_tensor(seps, device=dev),
            "max_leaves": torch.as_tensor(padded, device=dev)}
    q = torch.as_tensor(mixed_plan(rng, api).keys, device=dev)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    got = {k: search_positions(d, q) for k, d in dirs.items()}
    torch.cuda.synchronize()
    launches = _build.launch_counts["search_positions"]
    check(launches == len(dirs), f"search_positions: {launches} launches")
    rank = (I.rank_right(store.index, q) - 1).clamp_min(0)
    rows = []
    for k, d in dirs.items():
        twin = search_positions_ref(d, q)
        lib = (torch.searchsorted(d, q, right=True).int() - 1).clamp_min(0)
        for what, want in (("plain", twin), ("torch.searchsorted", lib),
                           ("rank_right", rank)):
            check(same(got[k], want), f"search_positions != {what} on the "
                                      f"{k} directory")
        ms = time_ms(lambda d=d: search_positions(d, q))
        plain_ms = time_ms(lambda d=d: search_positions_ref(d, q), iters=5)
        library_ms = time_ms(lambda d=d: torch.searchsorted(d, q, right=True))
        n_dir, P = d.numel(), q.numel()
        bound_bytes = (4 * n_dir + 2 * 4 * P) / HBM_BYTES_PER_S * 1e3
        bound_ops = P * max(1, int(np.ceil(np.log2(n_dir)))) \
            / INT32_OPS_PER_S * 1e3
        err = max_abs_err((got[k],), (twin,))
        say("kernel", name="search_positions", directory=k,
            shape=f"ML={n_dir},P={P}", ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}",
            bound_ms=f"{max(bound_bytes, bound_ops):.6f}",
            library_ms=f"{library_ms:.5f}", max_abs_err=err,
            launches=launches)
        rows.append(dict(
            name="search_positions", route="cuda",
            source=KERNELS["search_positions"][0],
            replaces=KERNELS["search_positions"][1], launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            library_ms=library_ms))
    # the JSON line holds one row per kernel: the TPU kernel's own input,
    # the directory padded to max_leaves
    return rows[-1:]


# ---------------------------------------------------------------------------
# phase 6: the self-sizing store lifecycle on the card
# ---------------------------------------------------------------------------

def lifecycle_phase(api, rng) -> None:
    """A tiny self-sizing store taken far past its pools: inserts, deletes
    and a held snapshot, every answer against a dict oracle."""
    from repro_torch.core import store as S

    db = api.Uruv(api.UruvConfig(leaf_cap=16, max_leaves=32,
                                 max_versions=1 << 12))
    want = {}
    keys = rng.choice(1 << 20, 20_000, replace=False).astype(np.int32)
    held = held_want = None
    for i in range(0, len(keys), 1000):
        k = keys[i:i + 1000]
        res = db.insert(k, k % 977 + 1)
        check(np.all(res.values == api.NOT_FOUND), "lifecycle: insert")
        want.update(zip(k.tolist(), (k % 977 + 1).tolist()))
        if i == 8000:
            held = db.acquire_snapshot()
            held_want = dict(want)
        dead = k[rng.random(len(k)) < 0.6]
        res = db.delete(dead)
        check(np.array_equal(res.values, [want.pop(int(x)) for x in dead]),
              "lifecycle: delete")
    probe = keys[::7]
    got = db.lookup(probe, held)
    check(np.array_equal(got, [held_want.get(int(x), api.NOT_FOUND)
                               for x in probe]), "lifecycle: held snapshot")
    db.release_snapshot(held)
    S.check_invariants(db.store)
    check(db.live_items() == sorted(want.items()), "lifecycle: live_items")
    st = db.stats
    check(st["grows"] > 0 and st["maintain_passes"] > 0,
          f"lifecycle: grows={st['grows']} "
          f"maintain_passes={st['maintain_passes']}")
    say("lifecycle", keys=len(keys), live=len(want), grows=st["grows"],
        maintain_passes=st["maintain_passes"],
        leaves_reclaimed=st["leaves_reclaimed"],
        max_leaves=db.capacity.max_leaves,
        max_versions=db.capacity.max_versions, result="exact")


# ---------------------------------------------------------------------------
# phase 7: the serving engine, llama3.2-1b at full width
# ---------------------------------------------------------------------------

class AttnRecorder:
    """Keeps the inputs of the widest flash / decode attention call the
    model made (wrapping the names ``repro_torch.models.common`` calls)."""

    def __init__(self, common):
        self.common = common
        self.orig = {"flash_attention": common.attention,
                     "decode_attention": common.decode}
        self.calls = {}

    def __enter__(self):
        self.common.attention = self._wrap("flash_attention",
                                           self.orig["flash_attention"])
        self.common.decode = self._wrap("decode_attention",
                                        self.orig["decode_attention"])
        return self

    def __exit__(self, *exc):
        self.common.attention = self.orig["flash_attention"]
        self.common.decode = self.orig["decode_attention"]

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            width = args[0].numel() * args[1].shape[-2]
            if width >= self.calls.get(name, (0,))[0]:
                self.calls[name] = (width, args, kw)
            return fn(*args, **kw)
        return rec


def serve_phase(args, rng) -> dict:
    """Two waves of requests through the engine; the prefix table's every
    answer is held against a host dict replay of the engine's plans."""
    import repro_torch.api as api
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = serve.build_engine("llama3_2_1b", seed=args.seed, slots=4,
                             max_len=512, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = eng.cfg
    plans = []
    submit = eng.coalescer.submit

    def logged(plan):
        fut = submit(plan)
        plans.append((plan, fut))
        return fut
    eng.coalescer.submit = logged

    prefill_ms, decode_ms = [], []

    def timed(fn, out):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            return r
        return run
    orig_prefill = transformer.prefill
    transformer.prefill = timed(orig_prefill, prefill_ms)
    eng._decode = timed(eng._decode, decode_ms)

    # wave 1: four conversations sharing the system prompt; the first
    # goes through prefill, the others copy its 256 cached rows.  wave 2:
    # follow-up turns of conversations 1-3 (each lands in another slot
    # than its first turn), a follow-up of the first of them, and one
    # fresh request on the system prompt.  A follow-up finds its donor
    # through the conversation's own prefix keys.  The fresh request
    # shows the engine's known fault (ROADMAP Queue 3 item 1): re-admitting
    # a slot retires every prefix key that slot published, the shared
    # system-prompt keys included, so it finds no donor; its reuse is
    # printed, not gated, and reads 256 once the fault is fixed.
    system = rng.integers(0, cfg.vocab, SYSTEM_PROMPT).tolist()

    def turn(prefix):
        return prefix + rng.integers(
            0, cfg.vocab, int(rng.integers(32, 65))).tolist()
    first = [turn(system) for _ in range(4)]
    second = [turn(first[1]), turn(first[2]), turn(first[3])]
    second.append(turn(second[0]))
    second.append(turn(system))
    waves = [[serve.Request(rid=w * 4 + i, prompt=p, max_new=32)
              for i, p in enumerate(prompts)]
             for w, prompts in enumerate((first, second))]
    follow_ups, fresh = waves[1][:4], waves[1][4]
    _build.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with AttnRecorder(common) as rec:
            for wave in waves:
                eng.run(wave)
            view = eng.snapshot_view()
        torch.cuda.synchronize()
    finally:
        transformer.prefill = orig_prefill
    wall_s = time.perf_counter() - t0
    counts = dict(_build.launch_counts)

    # the prefix table against a host dict replay of the engine's plans
    table = {}
    for plan, fut in plans:
        want = []
        for c, k, v in zip(plan.codes.tolist(), plan.keys.tolist(),
                           plan.values.tolist()):
            if c == api.OP_INSERT:
                want.append(table.get(k, api.NOT_FOUND))
                table[k] = v
            elif c == api.OP_DELETE:
                want.append(table.pop(k, api.NOT_FOUND))
            elif c == api.OP_SEARCH:
                want.append(table.get(k, api.NOT_FOUND))
            else:
                want.append(api.NOT_FOUND)
        check(np.array_equal(fut.result().values, want),
              "serve: a prefix-table answer differs from the host dict")
    check(view == sorted(table.items()), "serve: snapshot_view differs "
                                         "from the host dict")
    check(eng.table.active_snapshots == 0, "serve: snapshot not released")
    reqs = waves[0] + waves[1]
    check(all(r.done and len(r.out) == 32 for r in reqs),
          "serve: a request did not finish")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          "serve: a token outside the vocabulary")
    check(waves[0][0].prefix_reused == 0 and len(prefill_ms) >= 1,
          "serve: the first request did not go through prefill")
    check(all(r.prefix_reused >= SYSTEM_PROMPT for r in waves[0][1:]),
          "serve: a first-wave request did not reuse the system prompt")
    check(all(r.prefix_reused >= SYSTEM_PROMPT for r in follow_ups),
          "serve: a follow-up turn did not reuse the system prompt: "
          + str([r.prefix_reused for r in follow_ups]))
    for name in SERVE_KERNELS:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never ran on the serve path")
    new_tokens = sum(len(r.out) for r in reqs)
    stats = eng.table_stats
    say("serve", model=cfg.name, layers=cfg.n_layers, d=cfg.d_model,
        vocab=cfg.vocab, requests=len(reqs), build_s=f"{build_s:.3f}",
        wall_s=f"{wall_s:.3f}", new_tokens=new_tokens,
        tokens_per_s=f"{new_tokens / wall_s:.2f}",
        prefills=len(prefill_ms),
        prefill_ms_per_prompt=f"{np.mean(prefill_ms):.3f}",
        decode_calls=len(decode_ms),
        decode_ms_per_tick=f"{np.mean(decode_ms):.3f}",
        reused=json.dumps([r.prefix_reused for r in reqs]).replace(" ", ""),
        fresh_reused=fresh.prefix_reused,
        fresh_fault=("ROADMAP-Queue3-item1" if fresh.prefix_reused
                     < SYSTEM_PROMPT else "fixed"),
        max_memory_allocated_mib=(
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f}"),
        table_entries=len(view),
        table_stats=json.dumps(stats, sort_keys=True).replace(" ", ""),
        launches=json.dumps(counts, sort_keys=True).replace(" ", ""))
    return dict(counts=counts, calls=rec.calls)


# ---------------------------------------------------------------------------
# phase 8: the model on the CPU and on the card, same weights
# ---------------------------------------------------------------------------

def model_cpu_equals_cuda(args) -> None:
    """llama3.2-1b at full width, 2 layers: prefill + 8 teacher-forced
    decode steps on both devices from the same weights.

    fp32 (compute and KV cache) holds the algorithm: CPU and card agree
    within atol = rtol = ``FP32_TOL``.  bf16, the serving dtype, is held
    against a bound read from the run itself: the card's bf16 logits may
    stand at most ``BF16_SPREAD`` times as far from the CPU's fp32 logits
    as the CPU's own bf16 logits do, so a fault in the card's bf16 path
    fails while the two devices' different bf16 roundings pass."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.models import transformer as TT

    base = dataclasses.replace(get_arch("llama3_2_1b"), n_layers=2)
    params = TT.init(base, torch.Generator().manual_seed(args.seed))
    rng = np.random.default_rng(args.seed + 2)
    toks = rng.integers(0, base.vocab, (2, 24)).astype(np.int32)
    S0, Smax = 16, 32

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    def logits_on(cfg, dev):
        cache_dtype = (torch.float32 if cfg.compute_dtype == "float32"
                       else torch.bfloat16)
        p = to(params, dev)
        logits, cache = TT.prefill(cfg, p, toks[:, :S0], Smax, cache_dtype)
        steps = [logits[:, -1]]
        lens = np.full(2, S0, np.int32)
        for t in range(S0, S0 + 8):
            lg, cache = TT.decode_step(cfg, p, toks[:, t], cache, lens)
            lens += 1
            steps.append(lg)
        return torch.stack(steps).float().cpu().numpy()

    out = {}
    for cdt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=cdt)
        for dev in ("cpu", "cuda"):
            out[cdt, dev] = logits_on(cfg, dev)
            check(np.isfinite(out[cdt, dev]).all(),
                  f"cpu==cuda model: non-finite {cdt} logits on {dev}")
    ref = out["float32", "cpu"]
    err32 = float(np.abs(out["float32", "cuda"] - ref).max())
    check(np.allclose(out["float32", "cuda"], ref, atol=FP32_TOL,
                      rtol=FP32_TOL),
          f"cpu==cuda model: fp32 logits differ (max abs {err32:.3e})")
    spread_cpu = float(np.abs(out["bfloat16", "cpu"] - ref).max())
    spread_cuda = float(np.abs(out["bfloat16", "cuda"] - ref).max())
    check(spread_cuda <= BF16_SPREAD * spread_cpu,
          f"cpu==cuda model: the card's bf16 logits stand {spread_cuda:.3e} "
          f"from fp32, more than {BF16_SPREAD}x the CPU's {spread_cpu:.3e}")
    err16 = float(np.abs(out["bfloat16", "cuda"]
                         - out["bfloat16", "cpu"]).max())
    say("cpu==cuda-model", model=base.name, layers=base.n_layers,
        logits=ref.size, max_abs_err_fp32=f"{err32:.3e}",
        gate_fp32=f"atol=rtol={FP32_TOL}",
        bf16_cpu_from_fp32=f"{spread_cpu:.3e}",
        bf16_cuda_from_fp32=f"{spread_cuda:.3e}",
        gate_bf16=f"cuda<={BF16_SPREAD}x_cpu",
        max_abs_err_bf16=f"{err16:.3e}")


# ---------------------------------------------------------------------------
# phase 9: durability — WAL, full + delta checkpoints, recovery, kill -9
# ---------------------------------------------------------------------------

def _dir_mib(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*")
               if f.is_file()) / 2**20


def worker_plans(api, seed: int, n_keys: int) -> list:
    """A durability worker's plan stream, a pure function of the seed:
    ``n_keys`` distinct inserts in plans of WIDTH, then WORKER_MIXED fig9b
    plans."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(UNIVERSE, n_keys, replace=False).astype(np.int32)
    plans = [api.OpBatch.inserts(keys[i:i + WIDTH],
                                 keys[i:i + WIDTH] % 1000 + 1)
             for i in range(0, n_keys, WIDTH)]
    return plans + [mixed_plan(rng, api) for _ in range(WORKER_MIXED)]


def durable_worker(args) -> int:
    """``--durable-worker DIR``: apply the worker plan stream to a durable
    client of the main configuration on the card, print ``acked i`` once
    plan i's result is back (its record is on disk: ``group_commit=1``),
    checkpoint every WORKER_CKPT_EVERY plans.  The parent kills it by a
    crash point (``URUV_CRASH_POINT``); JAX cannot even be imported."""
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import repro_torch.api as api

    db = api.Uruv(api.UruvConfig(**MAIN_CFG), durable_dir=args.durable_worker)
    for i, plan in enumerate(worker_plans(api, args.seed, args.keys), 1):
        db.apply(plan)
        print(f"acked {i}", flush=True)
        if i % WORKER_CKPT_EVERY == 0:
            db.checkpoint()
    db.durability.close()
    print("done", flush=True)
    return 0


def kill9_worker(args, api, crash: str) -> dict:
    """Run one worker until its crash point kills it, recover its directory
    on the card and hold the result against a host replay of exactly the
    recovered prefix, which must cover every acknowledged plan."""
    import os
    import signal

    from repro_torch.distributed.fault import CRASH_POINT_ENV

    d = DURABLE_DIR / crash.replace(":", "_").replace(".", "_")
    env = dict(os.environ, **{CRASH_POINT_ENV: crash})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--durable-worker",
         str(d), "--keys", str(args.reduced), "--seed", str(args.seed + 3)],
        env=env, capture_output=True, text=True, timeout=600)
    worker_s = time.perf_counter() - t0
    check(proc.returncode == -signal.SIGKILL,
          f"durability worker at {crash}: rc={proc.returncode}, not killed\n"
          + proc.stderr[-2000:])
    acked = max((int(line.split()[1]) for line in proc.stdout.splitlines()
                 if line.startswith("acked ")), default=0)
    plans = worker_plans(api, args.seed + 3, args.reduced)
    bounds = np.cumsum([0] + [len(p) for p in plans]).tolist()
    db = api.Uruv.recover(d)
    check(db.ts in bounds, f"{crash}: recovered clock {db.ts} is not a plan "
                           "boundary")
    m = bounds.index(db.ts)
    check(acked <= m <= len(plans),
          f"{crash}: recovered {m} plans, the worker acknowledged {acked}")
    oracle = Oracle(api.NOT_FOUND, api.TOMBSTONE)
    op = dict(insert=api.OP_INSERT, delete=api.OP_DELETE)
    for plan in plans[:m]:
        crud = plan.codes != api.OP_RANGE
        oracle.crud(plan.codes[crud], plan.keys[crud], plan.values[crud], op)
    live = np.asarray(db.live_items(), np.int64).reshape(-1, 2)
    ks = np.nonzero(oracle.val != api.NOT_FOUND)[0]
    check(np.array_equal(live, np.stack([ks, oracle.val[ks]], 1)),
          f"{crash}: recovered items differ from the host replay")
    probe = np.concatenate([plans[0].keys[:2048], np.random.default_rng(
        args.seed).integers(0, UNIVERSE, 2048)]).astype(np.int32)
    check(np.array_equal(db.lookup(probe), oracle.val[probe]),
          f"{crash}: recovered lookups differ from the host replay")
    db.durability.close()
    return dict(crash=crash, acked=acked, recovered=m, plans=len(plans),
                checkpoint_step=db.recovery.checkpoint_step,
                replayed=db.recovery.replayed_plans,
                torn_bytes=db.recovery.wal.truncated_bytes,
                worker_s=round(worker_s, 3))


def durability_phase(args, api, rng, card: str,
                     volatile_ops_per_s: float) -> dict:
    """A durable client of the main configuration: prefill, full
    checkpoint, fig9b plans (a snapshot held from their middle), delta
    checkpoint, a WAL tail; dropped without closing and recovered on the
    card bit for bit; then the two kill -9 workers."""
    import shutil

    from repro_torch.checkpoint import manager as M
    from repro_torch.core import store as S
    from repro_torch.durability import recovery as R
    from repro_torch.kernels import _build

    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    d = DURABLE_DIR / "main"
    db = api.Uruv(api.UruvConfig(**MAIN_CFG), durable_dir=d, group_commit=8)
    wal = {"s": 0.0, "n": 0}
    log_plan = db.durability.log_plan

    def timed_log(*a, **kw):
        t = time.perf_counter()
        log_plan(*a, **kw)
        wal["s"] += time.perf_counter() - t
        wal["n"] += 1
    db.durability.log_plan = timed_log

    oracle = Oracle(api.NOT_FOUND, api.TOMBSTONE)
    keys = rng.choice(UNIVERSE, args.prefill, replace=False).astype(np.int32)
    for i in range(0, len(keys), WIDTH):
        k = keys[i:i + WIDTH]
        res = db.apply(api.OpBatch.inserts(k, k % 1000 + 1))
        check(np.all(res.values == api.NOT_FOUND),
              "durability: prefill insert saw a previous value")
        oracle.val[k] = k % 1000 + 1

    def timed_checkpoint(delta: bool):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = db.checkpoint(delta=delta)
        ms = (time.perf_counter() - t) * 1e3
        return step, ms, _dir_mib(d / "ckpt" / f"step_{step:08d}")
    full_step, full_ms, full_mib = timed_checkpoint(False)

    apply_s, n_ops = 0.0, 0
    n1, n2 = args.plans, max(1, args.plans // 2)
    held = held_val = None
    for p in range(n1 + n2):
        if p == n1 // 2:
            # registered inside the delta checkpoint: a snapshot takes a
            # clock tick that no WAL record carries (ROADMAP Queue 3 item 2)
            held = db.acquire_snapshot()
            held_val = oracle.val.copy()
        if p == n1:
            delta_step, delta_ms, delta_mib = timed_checkpoint(True)
        plan = mixed_plan(rng, api)
        t = time.perf_counter()
        res = db.apply(plan)
        apply_s += time.perf_counter() - t
        n_ops += len(plan)
        verify_plan(oracle, api, plan, res, f"durability: plan {p}")
    db.sync_durable()
    torch.cuda.synchronize()
    live_ts, live = db.ts, S.to_numpy(db.store)
    wal_ms_per_plan = wal["s"] / wal["n"] * 1e3

    # recover from the directory the live client leaves behind (never
    # closed), on the card; restore and replay timed apart
    timers = {"restore": 0.0, "replay": 0.0}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timers[name] += time.perf_counter() - t
            return out
        return run
    orig_restore, orig_replay = M.CheckpointManager.restore_store, R.replay
    M.CheckpointManager.restore_store = timed("restore", orig_restore)
    R.replay = timed("replay", orig_replay)
    _build.launch_counts.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        back = api.Uruv.recover(d)
        torch.cuda.synchronize()
    finally:
        M.CheckpointManager.restore_store, R.replay = orig_restore, orig_replay
    recover_ms = (time.perf_counter() - t) * 1e3
    counts = dict(_build.launch_counts)
    for name in STORE_KERNELS:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never ran in the recovery")

    check(back.ts == live_ts, f"durability: recovered clock {back.ts} != "
                              f"{live_ts}")
    check(back.recovery.replayed_plans == n2
          and back.recovery.checkpoint_step == delta_step,
          f"durability: replayed {back.recovery.replayed_plans} plans from "
          f"step {back.recovery.checkpoint_step}; want {n2} from {delta_step}")
    got = S.to_numpy(back.store)
    check(sorted(got) == sorted(live), "durability: store fields differ")
    for name in live:
        check(got[name].dtype == live[name].dtype
              and np.array_equal(got[name], live[name]),
              f"durability: the recovered store differs in {name}")
    lo = rng.integers(0, UNIVERSE - RANGE_SIZE, 64).astype(np.int32)
    probe = rng.integers(0, UNIVERSE, WIDTH).astype(np.int32)
    pages = [c.range_all(lo, lo + RANGE_SIZE - 1, held) for c in (db, back)]
    looks = [c.lookup(probe, held) for c in (db, back)]
    check(pages[0] == pages[1] and np.array_equal(*looks),
          "durability: the held snapshot reads differently after recovery")
    for a, pg in zip(lo.tolist(), pages[1]):
        check(np.array_equal(np.asarray(pg, np.int64).reshape(-1, 2),
                             oracle.range(a, a + RANGE_SIZE - 1, held_val)),
              "durability: a held-snapshot page differs from the oracle")
    check(np.array_equal(looks[1], held_val[probe]),
          "durability: a held-snapshot lookup differs from the oracle")
    for c in (db, back):
        c.release_snapshot(held)
        c.durability.close()

    # the WAL-tear worker dies appending its last even-numbered plan, one
    # plan after its last checkpoint, so its recovery replays a WAL tail
    n_w = len(worker_plans(api, args.seed + 3, args.reduced))
    tear = n_w - n_w % 2
    workers = [kill9_worker(args, api, crash) for crash in
               (f"wal.mid_append:{tear}", "ckpt.renamed:2")]
    check(workers[0]["replayed"] >= 1 and workers[0]["torn_bytes"] > 0,
          f"durability: the torn worker replayed no WAL tail: {workers[0]}")
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    out = dict(
        keys=args.prefill, plans=n1 + n2, full_step=full_step,
        full_mib=f"{full_mib:.3f}", full_ms=f"{full_ms:.3f}",
        delta_step=delta_step, delta_mib=f"{delta_mib:.3f}",
        delta_ms=f"{delta_ms:.3f}",
        delta_share=f"{delta_mib / full_mib:.5f}",
        wal_ms_per_plan=f"{wal_ms_per_plan:.4f}", wal_plans=wal["n"],
        durable_ops_per_s=f"{n_ops / max(apply_s, 1e-9):.1f}",
        volatile_ops_per_s=f"{volatile_ops_per_s:.1f}",
        recover_ms=f"{recover_ms:.3f}",
        restore_ms=f"{timers['restore'] * 1e3:.3f}",
        replay_ms=f"{timers['replay'] * 1e3:.3f}",
        replayed_plans=back.recovery.replayed_plans, result="bit-equal",
        launches=json.dumps(counts, sort_keys=True).replace(" ", ""),
        workers=json.dumps(workers).replace(" ", ""), card=repr(card))
    say("durability", **out)
    return out


# ---------------------------------------------------------------------------
# phase 10 (attention): the two attention kernels at the serve path's inputs
# ---------------------------------------------------------------------------

def attention_report(serve) -> list:
    """The two attention kernels at the widest inputs the serve path gave
    them; ``library_ms`` is one ``scaled_dot_product_attention`` call on
    the same inputs (GQA, and for decode q as one row with a length
    mask)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rows = []
    for name in ("flash_attention", "decode_attention"):
        _, a, kw = serve["calls"][name]
        if name == "flash_attention":
            q, k, v = (t.contiguous() for t in a)
            causal, window = kw.get("causal", True), kw.get("window", 0)

            def run(q=q, k=k, v=v):
                return flash_attention(q, k, v, causal=causal, window=window)

            def plain(q=q, k=k, v=v):
                return attention_ref(q, k, v, causal=causal, window=window)
            B, H, Sq, D = q.shape
            KVH, Skv = k.shape[1], k.shape[2]
            qi = torch.arange(Sq)[:, None]
            ki = torch.arange(Skv)[None, :]
            ok = torch.ones(Sq, Skv, dtype=torch.bool)
            if causal:
                ok &= qi >= ki
            if window > 0:
                ok &= qi - ki < window
            pairs = int(ok.sum()) * B * H
            nbytes = (q.numel() * 2 + k.numel() + v.numel()) \
                * q.element_size()
            shape = f"B={B},H={H},KVH={KVH},Sq={Sq},Skv={Skv},D={D}"

            def lib(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        else:
            q, k, v, lens = (t.contiguous() for t in a)

            def run(q=q, k=k, v=v, lens=lens):
                return decode_attention(q, k, v, lens)

            def plain(q=q, k=k, v=v, lens=lens):
                return decode_attention_ref(q, k, v, lens)
            B, H, D = q.shape
            KVH, S = k.shape[1], k.shape[2]
            n_rows = int(lens.clamp(0, S).sum())
            pairs = n_rows * H
            nbytes = (2 * q.numel() + 2 * n_rows * KVH * D) \
                * q.element_size() + 4 * B + 8 * B * H
            shape = f"B={B},H={H},KVH={KVH},S={S},D={D}"
            mask = (torch.arange(S, device=q.device)[None, :]
                    < lens[:, None])[:, None, None, :]

            def lib(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
        got, want = run(), plain()
        err = float((got.float() - want.float()).abs().max())
        # both round the same fp32 result to q's dtype: in bf16 they may
        # part by one rounding step, in fp32 by summation order only
        atol, rtol = ((1e-5, BF16_ULP) if q.dtype == torch.bfloat16
                      else (2e-5, 2e-5))
        check(torch.allclose(got.float(), want.float(), atol=atol,
                             rtol=rtol),
              f"{name} != plain at the serve path's inputs (max abs {err})")
        # the same inputs in fp32 hold the fp32 tolerance
        a32 = [t.float() if t.is_floating_point() else t
               for t in (q, k, v) + (() if name == "flash_attention"
                                     else (lens,))]
        if name == "flash_attention":
            g32 = flash_attention(*a32, causal=causal, window=window)
            w32 = attention_ref(*a32, causal=causal, window=window)
        else:
            g32, w32 = decode_attention(*a32), decode_attention_ref(*a32)
        err32 = float((g32 - w32).abs().max())
        check(torch.allclose(g32, w32, atol=2e-5, rtol=2e-5),
              f"{name} != plain in fp32 (max abs {err32})")
        ms = time_ms(run)
        plain_ms = time_ms(plain, iters=5)
        library_ms = time_ms(lib)
        flops = 4 * pairs * D
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / BF16_TC_FLOPS * 1e3
        src, replaces = KERNELS[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=serve["counts"].get(name, 0), max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            library_ms=library_ms))
        say("kernel", name=name, shape=shape, dtype=str(q.dtype),
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            bound_ms=f"{max(bound_bytes, bound_ops):.6f}",
            library_ms=f"{library_ms:.5f}", max_abs_err=f"{err:.3e}",
            max_abs_err_fp32=f"{err32:.3e}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill", type=int, default=1_000_000)
    ap.add_argument("--plans", type=int, default=16)
    ap.add_argument("--reduced", type=int, default=50_000)
    ap.add_argument("--durable-worker", metavar="DIR",
                    help="run one kill -9 worker of phase 9 into DIR")
    ap.add_argument("--keys", type=int, default=50_000,
                    help="the worker's prefill keys")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if args.durable_worker:
        return durable_worker(args)
    import repro_torch.api as api
    from repro_torch.kernels import _build

    # fp32 products in full fp32 (the reference's precision), no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    lifecycle_phase(api, rng)
    serve_res = serve_phase(args, rng)
    model_cpu_equals_cuda(args)
    facts = main_res["facts"]
    durability_phase(args, api, rng, card,
                     facts["n_ops"] / max(facts["apply_s"], 1e-9))
    rows = (kernel_report(main_res) + attention_report(serve_res)
            + search_positions_report(main_res, api, rng))
    say("done", seconds=f"{time.perf_counter() - t_all:.1f}", card=repr(card))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
