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
               intervals, pvalid=False slots): exact equality.  The
               locate kernels also on random levels at F = 4, 6, 8, 16
               and depth 1 to 6, on rows and pools at L = 8 to 200,
               ragged P, views 4 bytes off a 16-byte boundary (the 4-byte
               variants), leaf ids -1 and past both ends, queries
               KEY_MAX - 1 and KEY_MAX; ``search_positions`` at the edges
               of its staged design (directories of 0, 1, 1023, 1024 and
               1025 entries, a multiple and a non-multiple of the
               splitter stride, up to 524,289 entries, duplicate runs,
               long KEY_MAX padding, views 4 bytes off a 16-byte
               boundary; queries on and just below every splitter,
               KEY_MIN, KEY_MAX - 2, KEY_MAX - 1, KEY_MAX; P of 1, 31 and
               1000), also against ``torch.searchsorted``, one launch a
               call
  4. main      the single-device CRUD + range path through ``Uruv.apply``:
               prefill ``--prefill`` distinct keys of a 2,000,000-key
               universe in plans of 4096, then ``--plans`` mixed plans of
               the paper's fig9b mix (90% search, 5% update, 5% range of
               size 1000) plus ranges, lookups and 8 ``scan_page`` passes
               (the standalone ``versioned_read``'s path) under a held
               snapshot; every result is checked against a host-side
               oracle, then ``check_invariants`` and ``live_items``
  4b. profile two more fig9b plans under ``torch.profiler`` (device
               activity): wall time, device busy time, idle share,
               kernels and device-to-host copies per plan, top kernels
  4c. sharded  ``Uruv.sharded`` over ``make_host_mesh(4)``: four stores of
               the main configuration stacked on the card, the universe
               range-partitioned (``ShardedConfig(key_hi=2,000,000)``);
               the main path's workload (``--prefill`` keys in routed
               plans of 4096, ``--plans`` fig9b plans, the held-snapshot
               read), one plan whose keys all fall on shard 0 (the routing
               budget overflows: the replicated fallback) and
               ``make_ops``' ``range_q`` on 8 intervals; every answer
               against the oracle, ``check_invariants`` on each shard,
               the store kernels' launches, then a local ``Uruv`` fed the
               same seeded plans must give equal values, timestamps,
               pages and clock; prefill s, fig9b ops/s beside the local
               store's, routed and replicated passes, keys per shard,
               peak memory; two more fig9b plans profiled
               (``sharded-profile``)
  5. cpu==cuda the same seeded plans at ``--reduced`` keys on ``cuda`` and
               on ``device="cpu"``: the two stores must be bit-equal;
               then the same for a 4-shard ``Uruv.sharded`` store
               (``sharded-cpu==cuda``, every stacked array)
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
               request's reuse printed (ROADMAP reference fault R1), the launch
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
  8b. attention-bwd  the backward kernel (``csrc/flash_attention_bwd.cu``)
               against ``attention_bwd_ref`` and the forward's logsumexp
               against the twin's: fp32 and bf16; causal, window 64 and no
               mask; GQA 32/8 and 8/8; Sq = Skv of 1, 63, 256 and 309;
               bf16 at D 128 (train width) and at D 256 (the scalar
               kernels: the C entry's dispatch names which served each,
               and a trace's kernel names must agree);
               rows with no unmasked key (lse -inf, dq 0); the gradients
               within 1e-4 (fp32) / 2e-2 (bf16) of the call's largest
               gradient element, lse within 1e-5 / 1e-4; two bf16 calls at
               the train shape bit-identical; the fp32 forward 200 times on
               one input, every output and lse bit-identical to the first
  8c. train    llama3.2-1b at full width (seeded fp32 parameters, bf16
               compute, remat on), AdamW with 2 warmup steps, 8 steps of
               ``make_batch(cfg, 8, 256, step)``: step ms (CUDA events),
               tokens/s, peak memory, every loss (finite, the last below
               the first), 32 forward and 16 backward attention launches
               a step (remat reruns each layer's forward); no checkpoint
  8d. pipeline / train-serve  a ``StreamingSampleStore`` on the card
               ingests 262,144 sample ids in plans of 4096; an epoch at a
               held snapshot, read by 8 readers in one pass while 16,384
               more ids arrive, equals the host oracle; 4 batches of
               ``epoch_iterator`` (B = 8, S = 256) train the full-width
               state further; ``retire_below`` and ``compact``; the
               trained parameters serve through the port's ``Engine``: 4
               identical requests, 32 new tokens each, identical outputs;
               the store kernels' launches in the phase
  8e. train-cpu==cuda  one train step of llama3.2-1b at full width with 2
               layers on the CPU (plain twins) and on the card, same
               weights and batch: fp32 loss, grad norm and gradient within
               1e-4, update within 1e-2 (relative norm); bf16 no more than
               2x as far from the CPU's fp32 as the CPU's own bf16
  8f. train-restart  reduced llama3.2-1b on the card through
               ``run_with_restarts`` with a ``CheckpointManager`` under
               ``build/``: 12 steps, and 12 with crashes at 6 and 10; losses
               and parameters within rtol 1e-5 / atol 1e-6
 10. kernels   each kernel again at the widest inputs its path gave it:
               parity with its twin (exact for the int32 store kernels;
               attention within one bf16 ulp, atol 1e-5 + rtol 2^-7, in
               bf16 and within 2e-5 in fp32), its time, its plain twin's
               time, its bound and the PyTorch library call's time.
               ``ms`` is CUDA events around 20 wrapper calls (host checks,
               allocation and the launch included); ``device_ms`` is the
               kernels' own time per call from a ``torch.profiler`` trace
               of 20 calls (each kernel's mean over the launches the trace
               holds; both of decode's launches, split and combine,
               count; ``device_ms_by`` says ``events`` where three traces
               held too few launches and CUDA events on a queued stream
               read it instead), and the attention rows add
               ``library_device_ms``, the same reading for the
               ``scaled_dot_product_attention`` call.  The
               ``flash_attention_bwd`` row is the backward at the train
               phase's inputs (its library call SDPA's backward through
               autograd), with each of its kernels' device ms, the
               achieved TFLOP/s of its 7 tile products and the same
               inputs without the causal mask (twice the products), and
               the attention rows' ``launches`` add the
               serve, train and train-serve phases' (``launches_by``).
               Each row's ``launches`` is the main path's count,
               ``sharded_launches`` the sharded phase's.  The main
               path runs the ``leaf_slots`` kernel only in place, through
               the fused entry ``leaf_slots_at`` (the rank with each hit's
               chain walked in its launch): row ``leaf_slots_read``, at the
               widest call's inputs; no single PyTorch call computes it,
               so its ``library_ms`` is null.  Row ``leaf_slots`` is the
               rows form, the TPU kernel's signature, at its kernel-level
               entry on the leaf rows that call read, gathered, beside
               ``torch.searchsorted`` (``library_ms``,
               ``library_device_ms``); the main path launches it 0 times.
               The chain-walking rows (``leaf_slots_read``,
               ``versioned_read``, ``range_scan``) add
               ``latency_floor_ms``: the longest chain of dependent round
               trips their inputs need times the card's HBM load latency,
               read first by a pointer chase over 256 MiB
               (``csrc/latency_probe.cu``); the same probe over a warm
               4 MiB cycle reads the L2 load latency (both on the
               ``[latency]`` line).  The ``locate`` lines give one
               lookup, ``backend.locate`` at the main path's widest
               inputs, in two forms, fused and composed over gathered rows
               as the JAX package composes it (descent, gather, rank,
               gather, where, snapshot copy, ``versioned_read``): equal
               answers, wrapper and device time, kernels per call, the
               fused form exactly 2.
               ``search_positions`` (the flat-directory rank, which no path
               of either package calls: 0 launches) runs through its
               kernel-level entry (``side_launches``) on the main store's
               directory, as it stands and padded to ``max_leaves``, with
               one fig9b plan's keys, and must equal its twin,
               ``torch.searchsorted`` (its ``library_device_ms`` too) and
               the rank of the multi-level index that replaced the flat
               directory; its ``round_trips`` (the queries with the
               staged splitters, then the window) times the L2 latency
               give its ``latency_floor_ms`` (``floor_by`` "l2": the
               directory sits in L2)

The line before the last is the JSON ``kernels`` report; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing any result.
It imports nothing of JAX and nothing of the JAX package: the oracle is
written here.
"""

from __future__ import annotations

import argparse
import json
import re
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
    # leaf_slots_at with a snapshot: the in-leaf rank with the hit's
    # version chain walked in the same launch (the lookup's versioned_read)
    "leaf_slots_read": (
        "src/repro_torch/csrc/uruv_search.cu",
        "src/repro/kernels/versioned_read/versioned_read.py:52"),
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
    # the gradient of flash_attention: the TPU package has no backward
    # kernel; XLA differentiates the models' jnp attention (_sdpa)
    "flash_attention_bwd": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/models/common.py:111"),
    "search_positions": ("src/repro_torch/csrc/uruv_search.cu",
                         "src/repro/kernels/uruv_search/uruv_search.py:60"),
}
# the kernels each path launches: apply passes and lookups locate through
# the fused entry (leaf_slots_read), range passes through range_scan; the
# standalone versioned_read serves scan_page, which only the main path
# calls.  No path launches leaf_slots on gathered rows or search_positions:
# phase kernels calls them at their kernel-level entries.
PASS_KERNELS = ("index_descend", "leaf_slots_read", "range_scan")
STORE_KERNELS = PASS_KERNELS + ("versioned_read",)
SERVE_KERNELS = PASS_KERNELS + ("flash_attention", "decode_attention")
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd")
LATENCY_PROBE = "latency_probe"   # csrc source of load_latency_ms' chase
L2_BYTES = 50 * 2**20         # H100 SXM L2 cache
HBM_CHASE_MIB = 256           # latency probe cycles: five times the L2 ...
L2_CHASE_MIB = 4              # ... and far past L1, well inside the L2
SCAN_PAGES = 8                # main path: scan_page calls under the snapshot
SHARDS = 4                    # phase sharded: key-range shards on the card
DURABLE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_durable"
TRAIN_CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
WORKER_CKPT_EVERY = 2         # durability workers: a checkpoint every 2 plans
WORKER_MIXED = 4              # ... and 4 fig9b plans after their prefill
TRAIN_B, TRAIN_S = 8, 256     # phase train: llama3.2-1b batch and sequence
TRAIN_STEPS = 8               # ... steps, AdamW warmup over the first 2
TRAIN_WARMUP = 2
TRAIN_SERVE_BATCHES = 4       # phase train-serve: epoch batches trained on
SAMPLE_IDS = 262_144          # phase pipeline: sample ids in the epoch ...
SAMPLE_EXTRA = 16_384         # ... ingested while the epoch is held
SAMPLE_RETIRE = 65_536        # ... consumed ids retired, then compact
# attention-bwd: the backward kernel within this share of the call's
# largest gradient element of its twin (fp32: summation order; bf16: the
# outputs' one rounding); the forward's lse within these of the twin's
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
FWD_REPEATS = 200             # attention-bwd: the fp32 forward, one input
TRAIN_UPDATE_TOL = 1e-2       # train-cpu==cuda: fp32 update, relative norm
TRAIN_BF16_LOSS = 1e-2        # ... bf16 loss, relative to the fp32 loss


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


def kernel_trace(fn, calls: int) -> dict:
    """The durations (us) of every kernel ``torch.profiler`` saw on the
    card over ``calls`` calls of ``fn``, by kernel name."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_kernel.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    durs = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            durs.setdefault(e["name"], []).append(float(e["dur"]))
    return durs


def device_ms(fn, iters: int = 20) -> tuple:
    """Mean on-device kernel time of one call of ``fn``, and how it was
    read.  ``"profiler"``: from the kernels ``torch.profiler`` saw on the
    card over ``iters`` calls and two more (a trace can lose the last
    launches before it stops), for each kernel name the mean duration of
    its recorded launches times its launches per call (a call that
    launches two kernels counts both).  Unlike :func:`time_ms` it leaves
    out the host's work between launches (argument checks, allocation,
    the ``ctypes`` call).  When three traces in a row hold too few
    launches, ``"events"``: CUDA events around ``iters`` calls queued
    behind a spin kernel, so the host's work is hidden but the gaps
    between back-to-back kernels count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    calls = iters + 2
    for _ in range(3):
        durs = kernel_trace(fn, calls)
        per_call = {n: round(len(d) / calls) for n, d in durs.items()}
        if durs and min(per_call.values()) >= 1:
            return sum(per_call[n] * sum(d) / len(d)
                       for n, d in durs.items()) / 1e3, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)     # tens of ms: the calls queue behind it
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, "events"


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

def parity_edge_cases(rng, edge_rng, dev) -> None:
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
    n_cases += search_positions_edge_cases(rng, dev)
    n_cases += locate_edge_cases(edge_rng, dev)
    n_cases += chain_edge_cases(np.random.default_rng(edge_rng.integers(
        1 << 30)), dev)
    torch.cuda.synchronize()
    say("parity", cases=n_cases, result="exact")


def search_positions_edge_cases(rng, dev) -> int:
    """The flat-directory rank at the edges of its design (splitters at
    stride S staged in shared memory, K <= 1024 of them, then one window):
    directories of 0, 1, K - 1, K and K + 1 entries (the whole directory
    staged up to K), a multiple and a non-multiple of S (38,400 = 150 x
    256 and 38,401), 131,077 entries (K = 513), 524,288 (S = 512, K =
    1024) and 524,289 (S = 1024: two passes over a window), with
    duplicate runs and long KEY_MAX padding; queries on every entry
    dir[128 k] (each splitter among them) and just below it,
    KEY_MIN, KEY_MAX - 2, KEY_MAX - 1 and KEY_MAX; P of 1, 31 and 1000
    (not a multiple of the block's 32); a directory view 4 bytes off a
    16-byte boundary (the 4-byte variant).  Exact against the twin and
    ``torch.searchsorted``, one counted launch per call."""
    from repro_torch.core.ref import KEY_MAX, KEY_MIN
    from repro_torch.kernels import _build
    from repro_torch.kernels.uruv_search.ref import search_positions_ref
    from repro_torch.kernels.uruv_search.uruv_search import search_positions

    def dir_case(n_real, n_pad, dups):
        hi = max(n_real // 8, 1) if dups else 10**7
        d = np.sort(rng.integers(-10**7, hi, n_real) if dups else
                    rng.choice(10**7, n_real, replace=False))
        return np.concatenate([d, np.full(n_pad, KEY_MAX)]).astype(np.int32)

    def queries(d, n_rand):
        sp = d[::128]
        q = np.concatenate([rng.integers(-10**7 - 10, 10**7 + 10, n_rand),
                            d[:1024], d[:1024] - 1, sp, sp - 1,
                            [KEY_MIN, KEY_MAX - 2, KEY_MAX - 1, KEY_MAX]])
        return q.astype(np.int64).clip(KEY_MIN, KEY_MAX).astype(np.int32)

    def run(dk, qk, what):
        before = _build.launch_counts["search_positions"]
        got = search_positions(dk, qk)
        check(_build.launch_counts["search_positions"] == before + 1,
              f"search_positions: not one launch ({what})")
        lib = (torch.searchsorted(dk, qk, right=True).int() - 1).clamp_min(0)
        check(same(got, search_positions_ref(dk, qk)) and same(got, lib),
              f"search_positions != plain or torch.searchsorted ({what})")

    cases = [(0, 0, False), (1, 0, False), (1023, 0, False),
             (1024, 0, False), (1025, 0, False), (38_400, 0, True),
             (38_401, 0, False), (5, 1 << 17, False),
             (22_430, (1 << 17) - 22_430, True), ((1 << 17) + 5, 0, True),
             (1 << 19, 0, False), ((1 << 19) + 1, 0, True),
             (777, 3000, True)]
    n = 0
    for n_real, n_pad, dups in cases:
        d = dir_case(n_real, n_pad, dups)
        q = queries(d, 3000)
        what = f"n_dir={len(d)}, pad={n_pad}, dups={dups}"
        run(torch.as_tensor(d, device=dev), torch.as_tensor(q, device=dev),
            what)
        # the same directory 4 bytes off a 16-byte boundary
        buf = torch.zeros(len(d) + 1, dtype=torch.int32, device=dev)
        buf[1:] = torch.as_tensor(d, device=dev)
        run(buf[1:], torch.as_tensor(q, device=dev), what + ", unaligned")
        n += 2
    d = torch.as_tensor(dir_case(22_430, (1 << 17) - 22_430, False),
                        device=dev)
    q = torch.as_tensor(queries(d.cpu().numpy(), 100), device=dev)
    for P in (1, 31, 1000):
        run(d, q[torch.randperm(q.numel(), device=dev)[:P]], f"P={P}")
        n += 1
    return n


def chain_edge_cases(rng, dev) -> int:
    """The chain-walking kernels' variants and edges, exact against their
    twins: chains that cycle (self-loops newer than every snapshot),
    max_chain 0, 1 and 64, the snapshot per query and one for all (a
    scalar, an expanded view), the fused rank-and-read at L = 8, 33, 64
    on pools 4 bytes off a 16-byte boundary too, and range worklists
    all-invalid, ragged and random at L = 8, 33, 64.  Returns the number
    of cases."""
    from repro_torch.core.ref import KEY_MAX
    from repro_torch.kernels.uruv_range.ref import range_scan_ref
    from repro_torch.kernels.uruv_range.uruv_range import range_scan
    from repro_torch.kernels.uruv_search.ref import leaf_slots_at_ref
    from repro_torch.kernels.uruv_search.uruv_search import leaf_slots_at
    from repro_torch.kernels.versioned_read.ref import versioned_read_ref
    from repro_torch.kernels.versioned_read.versioned_read import (
        versioned_read)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    def off16(a):
        a = np.asarray(a, np.int32)
        buf = torch.empty(a.size + 1, dtype=torch.int32, device=dev)
        view = buf[1:].view(a.shape)
        view.copy_(torch.as_tensor(a))
        return view

    MV = 50_000
    ts = rng.integers(0, 50, MV)
    nxt = rng.integers(-1, MV, MV)
    ts[:5], nxt[:5] = 1000, np.arange(5)
    val = rng.integers(-2, 99, MV)
    val[::11] = -(2**31) + 1
    pools = (t(ts), t(nxt), t(val))

    def snaps(P):
        one = t(37)
        return t(rng.integers(-3, 53, P)), one, one.expand(P)

    n_cases = 0
    for P, chain in ((4099, 0), (4096, 1), (5000, 64), (1, 64)):
        vh = rng.integers(-1, MV, P)
        vh[::7] = rng.integers(0, 5, len(vh[::7]))
        vh = t(vh)
        for sn in snaps(P):
            got = versioned_read(vh, sn, *pools, max_chain=chain)
            check(same(got, versioned_read_ref(vh, sn, *pools,
                                               max_chain=chain)),
                  f"versioned_read != plain (P={P}, chain={chain}, "
                  f"snap={tuple(sn.shape)})")
            n_cases += 1

    ML = 512
    for P, L, chain in ((4096, 64, 64), (4099, 8, 1), (777, 33, 64)):
        pool = np.sort(rng.integers(0, 5000, (ML, L)), axis=1)
        pool[rng.random((ML, L)) < 0.1] = KEY_MAX
        pool = np.sort(pool, axis=1).astype(np.int32)
        vhp = rng.integers(-1, MV, (ML, L))
        vhp[:, ::9] = rng.integers(0, 5, vhp[:, ::9].shape)
        ids = rng.integers(-ML - 2, ML + 2, P).astype(np.int32)
        rows = pool[np.clip(np.where(ids < 0, ids + ML, ids), 0, ML - 1)]
        q = rng.integers(0, 5100, P).astype(np.int32)
        hit = rng.random(P) < 0.6
        q[hit] = rows[hit, rng.integers(0, L, P)[hit]]
        q[:2] = [KEY_MAX - 1, KEY_MAX][:min(2, P)]
        for put in (t, off16):
            lk, lv = put(pool), put(vhp)
            for sn in snaps(P):
                args = (lk, lv, t(ids), t(q), sn, *pools)
                got = leaf_slots_at(*args, max_chain=chain)
                want = leaf_slots_at_ref(*args, max_chain=chain)
                check(all(same(a, b) for a, b in zip(got, want)),
                      f"leaf_slots_at with a snapshot != plain (P={P}, "
                      f"L={L}, put={put.__name__}, "
                      f"snap={tuple(sn.shape)})")
                n_cases += 1

    ML = 2048
    for Q, S, L, valid, chain in ((32768, 1, 64, "ragged", 64),
                                  (4096, 1, 64, "none", 64),
                                  (300, 3, 8, "random", 1),
                                  (257, 2, 33, "random", 64)):
        lkeys = np.sort(rng.integers(0, 10_000, (ML, L)), axis=1)
        lvh = rng.integers(-1, MV, (ML, L))
        lvh[:, ::9] = rng.integers(0, 5, lvh[:, ::9].shape)
        lcnt = rng.integers(0, L + 1, ML)
        if valid == "random":
            pvalid = rng.random((Q, S)) < 0.8
        else:
            n_ok = 0 if valid == "none" else Q * S // 7 + 3
            pvalid = (np.arange(Q * S) < n_ok).reshape(Q, S)
        lids = np.where(pvalid, rng.integers(-ML - 2, ML + 2, (Q, S)), 0)
        k1 = rng.integers(0, 10_000, Q)
        k2 = k1 + rng.integers(-500, 3000, Q)          # inverted too
        head = (t(lids), t(pvalid, torch.bool), t(k1), t(k2),
                t(rng.integers(0, 60, Q)))
        for put in (t, off16):
            args = (*head, put(lkeys), put(lvh), t(lcnt), *pools)
            got = range_scan(*args, max_chain=chain)
            want = range_scan_ref(*args, max_chain=chain)
            check(all(same(a, b) for a, b in zip(got, want)),
                  f"range_scan != plain (Q={Q}, S={S}, L={L}, {valid}, "
                  f"put={put.__name__})")
            n_cases += 1
    return n_cases


def locate_edge_cases(rng, dev) -> int:
    """The locate kernels' variants and edges, exact against their twins;
    returns the number of cases.  ``rng`` is a generator of its own, so
    the phases after ``parity`` see the same seeded data as before these
    cases existed."""
    from repro_torch.core.ref import KEY_MAX, KEY_MIN
    from repro_torch.kernels.uruv_search.ref import (
        index_descend_ref, leaf_slots_at_ref, leaf_slots_ref)
    from repro_torch.kernels.uruv_search.uruv_search import (
        index_descend, leaf_slots, leaf_slots_at)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.int32)

    def off16(a):
        """int32 ``a`` on the card as a contiguous view 4 bytes past a
        16-byte boundary (the kernels' 4-byte variant)."""
        a = np.asarray(a, np.int32)
        buf = torch.empty(a.size + 1, dtype=torch.int32, device=dev)
        view = buf[1:].view(a.shape)
        view.copy_(torch.as_tensor(a))
        return view

    n_cases = 0
    # random levels (caps 4^(depth-1-l), child ids past both ends of the
    # level below): 16-byte loads at F = 4, 8, 16, 4-byte at F = 6 and on
    # levels 4 bytes off a 16-byte boundary; depth 1 to 6; ragged P;
    # queries KEY_MAX - 1 and KEY_MAX
    for F, depth, P, odd in ((4, 6, 4099, False), (6, 5, 4095, False),
                             (8, 1, 1, False), (16, 6, 4096, False),
                             (16, 3, 777, True), (6, 2, 33, True)):
        caps = [4 ** (depth - 1 - l) for l in range(depth)]
        keys, child = [], []
        for l, cap in enumerate(caps):
            k = np.sort(rng.integers(-1000, 1000, (cap, F)), axis=1)
            k[rng.random((cap, F)) < 0.25] = KEY_MAX
            below = caps[l - 1] if l else 5000
            c = rng.integers(-below - 2, below + 3, (cap, F))
            keys.append((off16 if odd else t)(np.sort(k, axis=1)))
            child.append((off16 if odd else t)(c))
        q = rng.integers(-1100, 1100, P)
        q[:3] = [KEY_MAX - 1, KEY_MAX, KEY_MIN][:min(3, P)]
        q = t(q.astype(np.int32))
        got = index_descend(keys, child, q)
        want = index_descend_ref(keys, child, q)
        check(all(same(a, b) for a, b in zip(got, want)),
              f"index_descend != plain (F={F}, depth={depth}, P={P}, "
              f"offset={odd})")
        n_cases += 1

    # gathered rows and the in-place entry (with a snapshot per query):
    # one 16-byte chunk per lane (L = 8, 40, 64, 128), several (L = 200)
    # and 4-byte loads (L = 33, and every pool again 4 bytes off a 16-byte
    # boundary); leaf ids -1 and past both ends; hits, misses, KEY_MAX - 1
    # and KEY_MAX; ragged P
    ML, MV = 4096, 10**6
    pools = (t(rng.integers(0, 50, MV)), t(rng.integers(-1, MV, MV)),
             t(rng.integers(-2, 99, MV)))
    for P, L in ((5000, 64), (777, 8), (1000, 33), (4099, 40), (4095, 128),
                 (300, 200)):
        pool = np.sort(rng.integers(0, 5000, (ML, L)), axis=1)
        pool[rng.random((ML, L)) < 0.1] = KEY_MAX
        pool = np.sort(pool, axis=1).astype(np.int32)
        vh = rng.integers(-1, 10**6, (ML, L)).astype(np.int32)
        ids = rng.integers(-ML - 2, ML + 2, P).astype(np.int32)
        ids[::5] = -1
        rows = pool[np.clip(np.where(ids < 0, ids + ML, ids), 0, ML - 1)]
        q = rng.integers(0, 5100, P).astype(np.int32)
        hit = rng.random(P) < 0.6
        q[hit] = rows[hit, rng.integers(0, L, P)[hit]]
        q[:7] = KEY_MAX - 1
        q[7:9] = KEY_MAX
        qt, it, sn = t(q), t(ids), t(rng.integers(-3, 53, P))
        for put in (t, off16):
            r = put(rows)
            got = leaf_slots(r, qt)
            check(all(same(a, b) for a, b in zip(got, leaf_slots_ref(r, qt))),
                  f"leaf_slots != plain (P={P}, L={L}, put={put.__name__})")
            lk, lv = put(pool), put(vh)
            got = leaf_slots_at(lk, lv, it, qt, sn, *pools, max_chain=64)
            want = leaf_slots_at_ref(lk, lv, it, qt, sn, *pools,
                                     max_chain=64)
            check(all(same(a, b) for a, b in zip(got, want)),
                  f"leaf_slots_at != plain (P={P}, L={L}, "
                  f"put={put.__name__})")
            n_cases += 2

    return n_cases


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


def prefill_width(n_done: int, ramp: bool) -> int:
    """The next prefill plan's width: WIDTH, or with ``ramp`` a third of
    the keys already in, in multiples of 4 from 64 up to WIDTH.  The
    sharded path has no halving slow path (a plan that sends more than
    ``leaf_cap`` new keys to one leaf is rejected, as in the JAX package),
    so an empty sharded store takes about 16 new keys a leaf at first."""
    return min(WIDTH, max(64, n_done // 3) // 4 * 4) if ramp else WIDTH


def run_plans(db, api, rng, oracle, n_keys: int, n_plans: int, *,
              verify: bool, tag: str, trace=None, ramp: bool = False):
    """Prefill ``n_keys`` distinct keys (plans of WIDTH, ramped up to it
    with ``ramp``: :func:`prefill_width`), then ``n_plans`` mixed plans
    with a held snapshot in the middle.  Returns timing facts.
    ``trace``, a list, receives every plan's values, timestamps and pages,
    the held snapshot's range pages and lookups, and the final clock: two
    stores fed the same seeded plans must give equal traces."""
    keys = rng.choice(UNIVERSE, n_keys, replace=False).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    while i < n_keys:
        k = keys[i:i + prefill_width(i, ramp)]
        i += len(k)
        res = db.apply(api.OpBatch.inserts(k, k % 1000 + 1))
        if trace is not None:
            trace += [res.values, res.timestamps]
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
        if trace is not None:
            trace += [res.values, res.timestamps, res.pages()]
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
        # the paper's single-interval RANGEQUERY over 64 chained leaves
        # (the standalone versioned_read's path), on the first intervals
        scans = [db.scan_page(int(a), int(a) + RANGE_SIZE - 1, held)
                 for a in lo[:SCAN_PAGES]]
        db.release_snapshot(held)
        if trace is not None:
            trace += [pages, got]
        if verify:
            for a, pg in zip(lo.tolist(), pages):
                exp = oracle.range(a, a + RANGE_SIZE - 1, held_val)
                check(np.array_equal(np.asarray(pg, np.int64).reshape(-1, 2),
                                     exp), f"{tag}: held-snapshot range")
            check(np.array_equal(got, held_val[probe_keys]),
                  f"{tag}: held-snapshot lookup")
            for a, page in zip(lo.tolist(), scans):
                exp = oracle.range(a, a + RANGE_SIZE - 1, held_val)
                items = np.asarray(page.items(), np.int64).reshape(-1, 2)
                check(np.array_equal(items, exp[:len(items)])
                      and (bool(page.truncated[0]) or len(items) == len(exp)),
                      f"{tag}: held-snapshot scan_page at {a}")
    if trace is not None:
        trace.append(db.ts)
    return dict(prefill_s=prefill_s, apply_s=apply_s, n_ops=n_ops)


class Recorder:
    """Keeps, per kernel, the inputs of the widest call the main path made
    (wrapping the names ``repro_torch.core.backend`` calls)."""

    NAMES = {"index_descend": "index_descend",
             "leaf_slots_at": "leaf_slots_at", "locate": "locate",
             "versioned_read": "versioned_read", "range_scan": "_range_scan"}
    QUERIES = {"index_descend": 2, "leaf_slots_at": 3, "locate": 3}

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
            width = args[self.QUERIES.get(name, 0)].numel()
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

def profile_plans(db, api, rng, n_plans: int = 2,
                  tag: str = "profile") -> dict:
    """Trace ``n_plans`` more fig9b plans on ``db`` (the main path's
    store, or the sharded phase's) and read the trace: wall time, device
    busy time (union of kernel intervals), kernel launches,
    device-to-host copies (host syncs) and the kernels that take the most
    device time."""
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
    path = (Path(__file__).resolve().parent / "build"
            / f"chip_smoke_{tag}_trace.json")
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
    check(kern, f"{tag}: the trace holds no kernel on the card")
    out = dict(plans=n_plans, wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
               idle_share=1 - busy_us / 1e3 / wall_ms,
               kernels_per_plan=len(kern) / n_plans,
               d2h_copies_per_plan=len(d2h) / n_plans)
    say(tag, **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                      for k, v in out.items()},
        top_kernels_ms=json.dumps({n[:40]: round(us / 1e3, 4)
                                   for n, us in top}).replace(" ", ""))
    return out


# ---------------------------------------------------------------------------
# phase 5: the same plans on cuda and on the CPU -> bit-equal stores
# ---------------------------------------------------------------------------

def cpu_equals_cuda(args, api, make=None, tag: str = "cpu==cuda",
                    seed: int = 1, ramp: bool = False) -> None:
    """``make(device)`` (default: a local ``Uruv`` of ``REDUCED_CFG``)
    on ``cuda`` and on the CPU, fed the same seeded plans: bit-equal
    stores, live-key counts and counters."""
    from repro_torch.core import store as S

    if make is None:
        def make(dev):
            return api.Uruv(api.UruvConfig(**REDUCED_CFG), device=dev)
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(args.seed + seed)
        db = make(dev)
        oracle = Oracle(api.NOT_FOUND, api.TOMBSTONE)
        run_plans(db, api, rng, oracle, args.reduced, 4, verify=False,
                  tag=dev, ramp=ramp)
        n_live = db.compact()
        db.reindex()
        out[dev] = (S.to_numpy(db.store), n_live, db.stats)
    a, b = out["cuda"][0], out["cpu"][0]
    check(sorted(a) == sorted(b), f"{tag}: store fields differ")
    for name in a:
        check(a[name].dtype == b[name].dtype
              and np.array_equal(a[name], b[name]),
              f"{tag}: stores differ in {name}")
    check(out["cuda"][1:] == out["cpu"][1:], f"{tag}: stats differ")
    say(tag, keys=args.reduced, fields=len(a), shape=a["leaf_keys"].shape,
        live_keys=out["cuda"][1], result="bit-equal")


# ---------------------------------------------------------------------------
# phase 4c: the key-range-sharded store, 4 shards on the card
# ---------------------------------------------------------------------------

def _same_trace(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        for x, y in zip(a, b))


def _count_calls(fns: dict, counter: dict, kind: str) -> dict:
    """``fns`` with every callable wrapped to count its calls."""
    def wrap(fn):
        def run(*a, **kw):
            counter[kind] += 1
            return fn(*a, **kw)
        return run
    return {k: wrap(f) for k, f in fns.items()}


def sharded_phase(args, api) -> dict:
    """``Uruv.sharded`` over ``make_host_mesh(SHARDS)``: SHARDS stores of
    the main configuration stacked on the card, keys range-partitioned
    over the 2,000,000-key universe.  The main path's workload (prefill in
    routed plans of 4096, fig9b plans, a held-snapshot read), a plan whose
    keys all fall on shard 0 (the routing budget overflows: the
    replicated fallback) and ``make_ops``' ``range_q`` (the paper's
    single-interval scan on every shard: the standalone
    ``versioned_read``), every answer against the oracle; the launch
    counts of that run; then a local ``Uruv`` fed the same seeded plans
    must give the same values, timestamps, pages and clock.  The phase
    draws from a generator of its own, so the phases after it see the
    same data with and without it."""
    from repro_torch.core import sharded as SH, store as S
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    base = api.UruvConfig(**MAIN_CFG)
    cfg = api.ShardedConfig(base=base, key_lo=0, key_hi=UNIVERSE)
    mesh = make_host_mesh(SHARDS)
    rng = np.random.default_rng(args.seed + 7)
    seed = int(rng.integers(1 << 31))
    op = dict(insert=api.OP_INSERT, delete=api.OP_DELETE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    db = api.Uruv.sharded(cfg, mesh)
    pool_mib = store_mib(db.store)
    ex = db.executor
    passes = {"routed": 0, "replicated": 0}
    ex._routed_fns = _count_calls(ex._routed_fns, passes, "routed")
    ex._apply_fns = _count_calls(ex._apply_fns, passes, "replicated")
    oracle = Oracle(api.NOT_FOUND, api.TOMBSTONE)
    trace = []
    _build.launch_counts.clear()
    facts = run_plans(db, api, np.random.default_rng(seed), oracle,
                      args.prefill, args.plans, verify=True, tag="sharded",
                      trace=trace, ramp=True)
    routed_plans = dict(passes)
    # one plan of fig9b's CRUD mix whose keys all fall on shard 0: each
    # source slice owes shard 0 all its WIDTH / SHARDS ops, twice the
    # routing budget
    span = cfg.span(SHARDS)
    r = rng.random(WIDTH)
    fb_codes = np.where(r < 0.9, api.OP_SEARCH, np.where(
        r < 0.95, api.OP_INSERT, api.OP_DELETE)).astype(np.int32)
    fb_keys = rng.integers(0, span, WIDTH).astype(np.int32)
    fb_vals = rng.integers(1, 1 << 20, WIDTH).astype(np.int32)
    fallback = api.OpBatch(fb_codes, fb_keys, fb_vals)
    before = dict(passes, device=db.stats["device_passes"])
    res = db.apply(fallback)
    check(np.array_equal(res.values,
                         oracle.crud(fb_codes, fb_keys, fb_vals, op)),
          "sharded: the forced fallback's results differ from the oracle")
    check(passes["routed"] - before["routed"] == 1
          and passes["replicated"] - before["replicated"] == 1
          and db.stats["device_passes"] - before["device"] == 2,
          "sharded: the forced plan did not take the routed pass and then "
          "the replicated fallback")
    trace += [res.values, res.timestamps, db.ts]
    # the paper's single-interval RANGEQUERY on every shard (range_q)
    _, _, range_q = SH.make_ops(cfg, mesh)
    lo = rng.integers(0, UNIVERSE - RANGE_SIZE, SCAN_PAGES).astype(np.int32)
    with db.snapshot() as snap:
        for a in lo.tolist():
            keys, vals, cnt, trunc = (x.cpu().numpy() for x in range_q(
                db.store, a, a + RANGE_SIZE - 1, snap))
            exp = oracle.range(a, a + RANGE_SIZE - 1)
            for s in range(SHARDS):
                mine = exp[(exp[:, 0] // span).clip(0, SHARDS - 1) == s] \
                    if len(exp) else exp
                got = np.stack([keys[s, :cnt[s]], vals[s, :cnt[s]]], 1)
                check(np.array_equal(got, mine[:len(got)])
                      and (bool(trunc[s]) or len(got) == len(mine)),
                      f"sharded: range_q at {a}, shard {s}")
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    for name in STORE_KERNELS:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never ran on the sharded path")
    for st in S.shard_views(db.store):
        S.check_invariants(st)
    live = np.asarray(db.live_items(), np.int64).reshape(-1, 2)
    ks = np.nonzero(oracle.val != api.NOT_FOUND)[0]
    check(np.array_equal(live, np.stack([ks, oracle.val[ks]], 1)),
          "sharded: live_items differs from the oracle")
    per_shard = np.bincount(np.minimum(ks // span, SHARDS - 1),
                            minlength=SHARDS)
    stats = db.stats

    # the local store, fed the same seeded plans
    local = api.Uruv(base)
    local_trace = []
    local_facts = run_plans(local, api, np.random.default_rng(seed),
                            Oracle(api.NOT_FOUND, api.TOMBSTONE),
                            args.prefill, args.plans, verify=False,
                            tag="sharded-local", trace=local_trace,
                            ramp=True)
    res = local.apply(fallback)
    local_trace += [res.values, res.timestamps, local.ts]
    check(_same_trace(trace, local_trace),
          "sharded: results, timestamps, pages or clock differ from the "
          "local store's")
    del local
    ops_per_s = [f["n_ops"] / max(f["apply_s"], 1e-9)
                 for f in (facts, local_facts)]
    say("sharded", shards=SHARDS, keys=args.prefill, plans=args.plans,
        prefill_s=f"{facts['prefill_s']:.3f}",
        mixed_ops_per_s=f"{ops_per_s[0]:.1f}",
        local_prefill_s=f"{local_facts['prefill_s']:.3f}",
        local_mixed_ops_per_s=f"{ops_per_s[1]:.1f}",
        routed_passes=routed_plans["routed"],
        replicated_passes=routed_plans["replicated"],
        device_passes=stats["device_passes"],
        slow_path_rounds=stats["slow_path_rounds"], grows=stats["grows"],
        maintain_passes=stats["maintain_passes"], fallback="exact",
        keys_per_shard=",".join(map(str, per_shard.tolist())),
        n_leaves=",".join(str(int(x)) for x in db.store.n_leaves),
        pools_mib=f"{pool_mib:.1f}",
        max_memory_allocated_mib=f"{peak_mib:.1f}",
        local="equal", launches=json.dumps(counts, sort_keys=True)
        .replace(" ", ""))
    prof = profile_plans(db, api, rng, tag="sharded-profile")
    return dict(counts=counts, facts=facts, local_facts=local_facts,
                profile=prof)


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


def _walk_loads(vhead, snap, ver_ts, ver_next, max_chain) -> int:
    """The most dependent round trips one chain walk takes at these
    inputs, with each hop's ts, next and value loaded together
    (``uruv::resolve_chains``): a load per hop until a version at or
    before the snapshot or the chain's end, and one more read for a
    chain still newer after ``max_chain`` steps."""
    n = ver_ts.shape[0]
    cur = vhead.long()
    walking = cur >= 0
    loads = torch.zeros_like(cur)
    for _ in range(max_chain):
        if not bool(walking.any()):
            break
        loads += walking
        c = cur.clamp(0, n - 1)
        adv = walking & (ver_ts[c] > snap)
        cur = torch.where(adv, ver_next[c].long(), cur)
        walking = adv & (cur >= 0)
    loads += walking
    return int(loads.max()) if loads.numel() else 0


def load_latency_ms(dev, mib: int, steps: int = 20_000) -> float:
    """The card's dependent-load latency, ms per load: a pointer chase
    (``csrc/latency_probe.cu``, one thread, loads cached in L2 only)
    through one random cycle over ``mib`` MiB of int32, timed with CUDA
    events over ``steps`` loads after a warm-up chase.  Over a cycle
    larger than the L2 it reads HBM: the warm-up takes ``steps`` loads and
    the timed chase goes on from where it stopped, so it touches almost no
    line the warm-up brought into L2.  Over a cycle of a few MiB it reads
    L2: the warm-up walks the whole cycle, so every line is in L2."""
    import ctypes

    from repro_torch.kernels import _build

    n = mib << 18
    warm = steps if mib << 20 > L2_BYTES else n
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(n, device=dev, generator=gen)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[perm] = perm.roll(-1).int()
    start = int(perm[0])
    del perm
    out = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _build.load(LATENCY_PROBE, {"uruv_pointer_chase": (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p)})

    def chase(first, k):
        _build.check(lib.uruv_pointer_chase(nxt.data_ptr(), first, k,
                                            out.data_ptr(),
                                            _build.stream_ptr(out)),
                     "pointer_chase")
    chase(start, warm)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    first = int(out)          # synchronises: the warm-up is done
    t0.record()
    chase(first, steps)
    t1.record()
    torch.cuda.synchronize()
    check(0 <= int(out) < n, "latency probe: the chase left the buffer")
    return t0.elapsed_time(t1) / steps


def latencies(dev) -> dict:
    """The HBM and the L2 dependent-load latencies (ms per load), printed
    on the ``[latency]`` line: the chain walkers' floors take the first,
    ``search_positions``' (its directory sits in L2) the second."""
    lat = {"hbm": load_latency_ms(dev, HBM_CHASE_MIB),
           "l2": load_latency_ms(dev, L2_CHASE_MIB)}
    say("latency", hbm_dependent_load_us=f"{lat['hbm'] * 1e3:.4f}",
        buffer_mib=HBM_CHASE_MIB,
        l2_dependent_load_us=f"{lat['l2'] * 1e3:.4f}",
        l2_buffer_mib=L2_CHASE_MIB, probe="csrc/latency_probe.cu")
    return lat


def _bound(nbytes: float, nops: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    HBM's rate and the int32 operations over the card's 32-bit rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / INT32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def composed_lookup(index, leaf_keys, leaf_vhead, queries, snap_ts,
                    versions, *, max_chain):
    """A lookup composed as the JAX package composes it, and as the store
    ran it before the in-leaf rank read its leaf row in place and walked
    the hit's chain: the descent, a [P, L] gather of leaf rows, the rank
    on the gathered rows, a clamp, a second gather and a ``where`` for the
    version head, the snapshot copied out to [P], and a standalone
    ``versioned_read``."""
    from repro_torch.kernels.uruv_search.uruv_search import (
        index_descend, leaf_slots)
    from repro_torch.kernels.versioned_read.versioned_read import (
        versioned_read)

    L = leaf_keys.shape[1]
    bnode, bslot, leaf_id = index_descend(index.node_keys, index.node_child,
                                          queries)
    slot, exists = leaf_slots(leaf_keys[leaf_id], queries)
    vhead = torch.where(exists, leaf_vhead[leaf_id, slot.clamp_max(L - 1)],
                        -1)
    snap = snap_ts.expand(vhead.shape).contiguous()
    return (bnode, bslot, leaf_id, slot, exists, vhead,
            versioned_read(vhead, snap, *versions, max_chain=max_chain))


def locate_report(main) -> dict:
    """One lookup, ``backend.locate`` at the main path's widest inputs, in
    two forms: the fused two-launch one the store runs and the
    composition over gathered rows (:func:`composed_lookup`).  They must
    agree exactly; each form gets its wrapper time (``ms``), its device
    time (every kernel of the call, PyTorch's included) and its kernels
    per call from a trace.  The fused form must be exactly 2 kernels per
    call."""
    from repro_torch.core import backend

    _, a, kw = main["calls"]["locate"]
    forms = {"lookup": (backend.locate, a, kw),
             "lookup_composed": (composed_lookup, a, kw)}
    got = backend.locate(*a, **kw)
    want = composed_lookup(*a, **kw)
    check(len(got) == len(want)
          and all(same(u, v) for u, v in zip(got, want)),
          "locate: the lookup form != the lookup_composed form")
    out = {}
    for form, (fn, args, kwargs) in forms.items():
        ms = time_ms(lambda: fn(*args, **kwargs))
        dev_ms, dev_by = device_ms(lambda: fn(*args, **kwargs))
        # launches per call of each kernel the trace holds (a trace can
        # lose its last few launches, hence the rounding; late in a run
        # one can lose them all, so an empty trace is taken again, up to
        # three times, as device_ms does)
        calls = 22
        for _ in range(3):
            durs = kernel_trace(lambda: fn(*args, **kwargs), calls)
            if durs:
                break
        n_kern = sum(round(len(d) / calls) for d in durs.values())
        out[form] = dict(ms=ms, device_ms=dev_ms, device_ms_by=dev_by,
                         kernels_per_call=n_kern)
        say("locate", form=form, P=a[3].numel(), ms=f"{ms:.5f}",
            device_ms=f"{dev_ms:.5f}", device_ms_by=dev_by,
            kernels_per_call=n_kern)
    check(out["lookup"]["kernels_per_call"] == 2,
          "locate: the lookup form is not two kernels per call")
    return out


def kernel_report(main, lat_ms: float) -> list:
    """The store kernels at the widest inputs the main path gave them:
    exact against their twins, ``ms``, ``device_ms``, the twin's time,
    ``bound_ms``; the chain-walking rows add ``latency_floor_ms``, their
    longest chain of dependent round trips at these inputs times the
    card's HBM load latency ``lat_ms`` (:func:`latencies`)."""
    from repro_torch.core._ops import jax_index
    from repro_torch.core.ref import KEY_MAX
    from repro_torch.kernels.uruv_range.ref import range_scan_ref
    from repro_torch.kernels.uruv_range.uruv_range import range_scan
    from repro_torch.kernels.uruv_search import uruv_search as US
    from repro_torch.kernels.uruv_search.ref import (
        index_descend_ref, leaf_slots_at_ref, leaf_slots_ref)
    from repro_torch.kernels.versioned_read.ref import versioned_read_ref
    from repro_torch.kernels.versioned_read.versioned_read import (
        versioned_read)

    calls = main["calls"]
    launches = main["counts"]
    # the main path launches the leaf_slots kernel only in place, through
    # the fused entry (leaf_slots_read); row leaf_slots is its rows form,
    # the TPU kernel's signature, on the leaf rows that call read
    at_args, at_kw = calls["leaf_slots_at"][1:]
    pool, at_ids = at_args[0], at_args[2]
    leaf_rows = pool[jax_index(at_ids, pool.shape[0]).long()]
    kern = {"index_descend": (US.index_descend, index_descend_ref,
                              calls["index_descend"][1:]),
            "leaf_slots": (US.leaf_slots, leaf_slots_ref,
                           ((leaf_rows, at_args[3]), {})),
            "leaf_slots_read": (US.leaf_slots_at, leaf_slots_at_ref,
                                (at_args, at_kw)),
            "versioned_read": (versioned_read, versioned_read_ref,
                               calls["versioned_read"][1:]),
            "range_scan": (range_scan, range_scan_ref,
                           calls["range_scan"][1:])}
    rows = []
    for name, (fn, ref, (a, kw)) in kern.items():
        outs = fn(*a, **kw)
        refs = ref(*a, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        check(all(same(x, y) for x, y in zip(outs, refs)),
              f"{name} != plain at the main path's inputs")
        err = max_abs_err(outs, refs)
        ms = time_ms(lambda: fn(*a, **kw))
        dev_ms, dev_by = device_ms(lambda: fn(*a, **kw))
        plain_ms = time_ms(lambda: ref(*a, **kw), iters=5)
        library_ms = library_dev_ms = None
        round_trips = None
        extra = {}
        if name == "index_descend":
            keys, child, q = a
            P, F = q.numel(), keys[0].shape[1]
            n_rows, n_ents = _descent_touch(keys, child, q, KEY_MAX)
            nbytes = 4 * P + 3 * 4 * P + n_rows * F * 4 + n_ents * 4
            nops = 2 * P * len(keys) * F
            shape = f"P={P},D={len(keys)},F={F}"
        elif name == "leaf_slots":
            # the gathered rows and queries in; slot and exists out
            rws, qs = a
            P, L = rws.shape
            nbytes = 4 * P * L + 4 * P + 4 * P + P
            nops = P * L
            library_ms = time_ms(lambda: torch.searchsorted(rws, qs[:, None]))
            library_dev_ms, _ = device_ms(
                lambda: torch.searchsorted(rws, qs[:, None]))
            extra["path"] = ("kernel-level entry, on the rows the widest "
                             "leaf_slots_read call read, gathered")
            shape = f"P={P},L={L}"
        elif name == "leaf_slots_read":
            # in place: the distinct leaf rows the queries read, one
            # version head per hit, the chains; ids, queries and
            # snapshots in; slot, exists, vhead and the value out
            lk, lvh, ids, q, sn, vts, vnx, vval = a
            P, L = q.numel(), lk.shape[1]
            n_rows = _unique(jax_index(ids, lk.shape[0]))
            n_hits = int(outs[1].sum())
            n_ts, n_next, n_val = _chain_touch(outs[2], sn, vts, vnx,
                                               kw["max_chain"])
            nbytes = (8 * P + 4 * sn.numel() + n_rows * L * 4 + 4 * n_hits
                      + 4 * (n_ts + n_next + n_val) + 13 * P)
            nops = P * L + 2 * (n_ts + P)
            # ids, queries and snapshots; the leaf row; the chain
            round_trips = 2 + _walk_loads(outs[2], sn, vts, vnx,
                                          kw["max_chain"])
            shape = (f"P={P},ML={lk.shape[0]},L={L},MV={vts.numel()},"
                     f"snap={tuple(sn.shape)}")
        elif name == "versioned_read":
            vh, sn, vts, vnx, vval = a
            n_ts, n_next, n_val = _chain_touch(vh, sn, vts, vnx,
                                               kw["max_chain"])
            P = vh.numel()
            nbytes = 4 * P + 4 * sn.numel() + 4 * P + 4 * (n_ts + n_next
                                                           + n_val)
            nops = 2 * (n_ts + P)
            round_trips = 1 + _walk_loads(vh, sn, vts, vnx, kw["max_chain"])
            shape = f"P={P},MV={vts.numel()},snap={tuple(sn.shape)}"
            extra["lookup_inputs"] = lookup_inputs_report(
                kern["leaf_slots_read"][2], versioned_read,
                versioned_read_ref, lat_ms)
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
            # lids, pvalid, k1, k2, snapshot; the leaf row; the chains
            round_trips = (2 + _walk_loads(cand_vh, snap_c, vts, vnx,
                                           kw["max_chain"])
                           if bool(pv.any()) else 1)
            extra["valid_rows"] = int(pv.sum())
            shape = f"Q={Q},S={S},L={L}"
        bound_ms, bound_by = _bound(nbytes, nops)
        if round_trips is not None:
            extra.update(round_trips=round_trips,
                         latency_floor_ms=round_trips * lat_ms)
        src, replaces = KERNELS[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches.get(name, 0), max_abs_err=err,
            ms=ms, device_ms=dev_ms, device_ms_by=dev_by, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            library_device_ms=library_dev_ms, **extra))
        say("kernel", name=name, shape=shape, ms=f"{ms:.5f}",
            device_ms=f"{dev_ms:.5f}", device_ms_by=dev_by,
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.6f}",
            latency_floor_ms=("none" if round_trips is None else
                              f"{round_trips * lat_ms:.6f}"),
            round_trips=round_trips, launches=launches.get(name, 0),
            library_ms=library_ms if library_ms is None
            else f"{library_ms:.5f}",
            library_device_ms=library_dev_ms if library_dev_ms is None
            else f"{library_dev_ms:.5f}", max_abs_err=err)
    return rows


def lookup_inputs_report(fused_call, fn, ref, lat_ms) -> dict:
    """The standalone versioned_read at the inputs the lookup gave it
    before the chain walk was fused (as :func:`composed_lookup` builds
    them from the fused call's inputs: the version heads, the snapshot
    copied out to [P]), so its time compares with an earlier tree's
    ``versioned_read`` row, which the main path's lookups launched:
    exact against its twin, ``ms``, ``device_ms``, bound and latency
    floor."""
    from repro_torch.kernels.uruv_search.uruv_search import leaf_slots_at

    a, kw = fused_call
    vhead = leaf_slots_at(*a, **kw)[2]
    snap = a[4].expand(vhead.shape).contiguous()
    args = (vhead, snap, *a[5:])
    got, want = fn(*args, **kw), ref(*args, **kw)
    check(same(got, want), "versioned_read != plain at the lookup's inputs")
    ms = time_ms(lambda: fn(*args, **kw))
    dev_ms, dev_by = device_ms(lambda: fn(*args, **kw))
    P = vhead.numel()
    n_ts, n_next, n_val = _chain_touch(vhead, snap, *a[5:7],
                                       kw["max_chain"])
    bound_ms, bound_by = _bound(12 * P + 4 * (n_ts + n_next + n_val),
                                2 * (n_ts + P))
    round_trips = 1 + _walk_loads(vhead, snap, *a[5:7], kw["max_chain"])
    say("kernel", name="versioned_read", form="lookup_inputs",
        shape=f"P={P},snap={tuple(snap.shape)}", ms=f"{ms:.5f}",
        device_ms=f"{dev_ms:.5f}", device_ms_by=dev_by,
        bound_ms=f"{bound_ms:.6f}",
        latency_floor_ms=f"{round_trips * lat_ms:.6f}",
        round_trips=round_trips, max_abs_err=max_abs_err((got,), (want,)))
    return dict(ms=ms, device_ms=dev_ms, device_ms_by=dev_by,
                bound_ms=bound_ms, bound_by=bound_by,
                round_trips=round_trips,
                latency_floor_ms=round_trips * lat_ms)


def _search_trips(n_dir: int) -> int:
    """The dependent round trips of one ``search_positions`` query: the
    query's load with the block's staged splitters, then the window's
    (none when the whole directory is staged: ``n_dir`` <= 1024, kSpMax
    in ``csrc/uruv_search.cu``).  Up to 524,288 entries the window (S <=
    512) is one pass of 16-byte loads; larger directories are not
    reported."""
    check(n_dir <= 1 << 19, f"search_positions: no trip count for {n_dir}")
    return 1 if n_dir <= 1024 else 2


def search_positions_report(main, api, rng, l2_ms: float) -> list:
    """The flat-directory rank on the main store's directory (length
    ``n_leaves``) and on that directory padded with KEY_MAX to
    ``max_leaves``, as the TPU wrapper pads, for the keys of one fig9b
    plan.  No path of either package calls it (the multi-level index
    replaced the flat directory), so its ``launches`` is the main path's
    0, and it is called at its kernel-level entry: the counts are set to 0
    just before the two calls and read just after (``side_launches``).
    Then each result is held against the twin,
    ``torch.searchsorted`` (its library time) and ``max(rank_right - 1,
    0)`` of the store's multi-level index: exact.  Each reading adds
    ``round_trips`` (:func:`_search_trips`) and ``latency_floor_ms``,
    those trips times the card's L2 load latency ``l2_ms`` (the directory
    sits in L2: ``floor_by`` "l2").  The JSON row is the padded
    directory's, the TPU kernel's own input, with the ``n_leaves``
    reading nested."""
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
    side = _build.launch_counts["search_positions"]
    check(side == len(dirs), f"search_positions: {side} launches")
    launches = main["counts"].get("search_positions", 0)
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
        dev_ms, dev_by = device_ms(lambda d=d: search_positions(d, q))
        plain_ms = time_ms(lambda d=d: search_positions_ref(d, q), iters=5)
        library_ms = time_ms(lambda d=d: torch.searchsorted(d, q, right=True))
        library_dev_ms, _ = device_ms(
            lambda d=d: torch.searchsorted(d, q, right=True))
        n_dir, P = d.numel(), q.numel()
        bound_ms, bound_by = _bound(
            4 * n_dir + 2 * 4 * P, P * max(1, int(np.ceil(np.log2(n_dir)))))
        err = max_abs_err((got[k],), (twin,))
        trips = _search_trips(n_dir)
        say("kernel", name="search_positions", directory=k,
            shape=f"ML={n_dir},P={P}", ms=f"{ms:.5f}",
            device_ms=f"{dev_ms:.5f}", device_ms_by=dev_by,
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.6f}",
            latency_floor_ms=f"{trips * l2_ms:.6f}", round_trips=trips,
            floor_by="l2", library_ms=f"{library_ms:.5f}",
            library_device_ms=f"{library_dev_ms:.5f}", max_abs_err=err,
            launches=launches, side_launches=side)
        rows.append(dict(
            name="search_positions", route="cuda",
            source=KERNELS["search_positions"][0],
            replaces=KERNELS["search_positions"][1], launches=launches,
            side_launches=side, max_abs_err=err, ms=ms, device_ms=dev_ms,
            device_ms_by=dev_by, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, round_trips=trips,
            latency_floor_ms=trips * l2_ms, floor_by="l2",
            library_ms=library_ms, library_device_ms=library_dev_ms,
            shape=f"ML={n_dir},P={P}"))
    # the JSON line holds one row per kernel: the TPU kernel's own input,
    # the directory padded to max_leaves, with the n_leaves reading nested
    padded_row, leaves_row = rows[1], rows[0]
    padded_row["n_leaves"] = {
        k: v for k, v in leaves_row.items()
        if k not in ("name", "route", "source", "replaces", "launches",
                     "side_launches")}
    return [padded_row]


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
                # detached: a kept training input would keep its graph
                self.calls[name] = (width, tuple(a.detach() for a in args),
                                    kw)
            return fn(*args, **kw)
        return rec


def serve_phase(args, rng) -> dict:
    """Two waves of requests through the engine; the prefix table's every
    answer is held against a host dict replay of the engine's plans."""
    import repro_torch.api as api
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
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
    # shows the engine's known fault (ROADMAP reference fault R1): re-admitting
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
        fresh_fault=("ROADMAP-reference-fault-R1" if fresh.prefix_reused
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
# phases 8b-8f: training — the attention's backward, llama3.2-1b steps, the
# same step on the CPU, crash-restart, the sample store feeding the trainer
# ---------------------------------------------------------------------------

def _grad_err(got, want) -> float:
    """Largest |got - want| over a call's gradients, over the largest
    |want| element among them."""
    scale = max(float(w.float().abs().max()) for w in want) or 1.0
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want)) / scale


def attention_bwd_phase(dev) -> None:
    """The backward kernel against ``attention_bwd_ref`` and the forward's
    logsumexp against the twin's: fp32 and bf16; causal, window 64 and no
    mask; GQA 32/8 and 8/8; Sq = Skv of 1, 63, 256 and 309; and rows with
    no unmasked key.  Both backwards get the kernel forward's own o and
    lse."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.flash_attention import (
        _bwd_route, flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_ref)

    g = torch.Generator().manual_seed(19)
    worst = {}
    n = 0
    _build.launch_counts.clear()

    def case(dtype, B, H, KVH, S, D, causal, window, tag):
        q, k, v, do = (
            torch.randn(s, generator=g).to(dev, dtype)
            for s in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D),
                      (B, H, S, D)))
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        _, wlse = attention_ref(q, k, v, causal=causal, window=window,
                                return_lse=True)
        lse_err = float((lse - wlse).abs().max())
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
        want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
        err = _grad_err(got, want)
        tag = f"{dtype} {tag} H={H}/{KVH} S={S} D={D}"
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"attention-bwd: non-finite gradient, {tag}")
        check(err <= BWD_TOL[dtype], f"attention-bwd: {tag}: "
              f"error {err:.3e} of max |grad| > {BWD_TOL[dtype]}")
        check(lse_err <= LSE_TOL[dtype], f"attention-bwd: {tag}:"
              f" lse off by {lse_err:.3e} > {LSE_TOL[dtype]}")
        w = worst.setdefault(str(dtype), [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], lse_err)
        return q, k, v, o, lse, do

    for dtype in (torch.float32, torch.bfloat16):
        for mask, causal, window in (("causal", True, 0),
                                     ("window64", True, 64),
                                     ("none", False, 0)):
            for H, KVH in ((32, 8), (8, 8)):
                for S in (1, 63, 256, 309):
                    case(dtype, 2, H, KVH, S, 64, causal, window, mask)
                    n += 1
    bf16 = torch.bfloat16
    # bf16 at D 128 (qwen3-4b's head dim) at train width; bf16 above D 128
    # takes the scalar kernels: the C entry's dispatch says which served,
    # and the trace's kernel names must agree where a trace holds them
    case(bf16, 1, 32, 8, TRAIN_S, 128, True, 0, "causal")
    n += 1
    served = {}
    for D in (64, 256):
        args = case(bf16, 1, 4, 2, 70, D, True, 0, "causal")
        n += 1
        route = _bwd_route(bf16, D)
        check(route == ("tc" if D <= 128 else "scalar"),
              f"attention-bwd: bf16 D={D} dispatched to {route}")

        def call(args=args):
            q, k, v, o, lse, do = args
            return flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        names = {}
        for _ in range(3):           # an empty trace is taken again
            n += 2
            names = kernel_trace(call, 2)
            if names:
                break
        seen = {("tc" if "::tc::" in nm else "scalar" if "::scalar::" in nm
                 else "?") for nm in names}
        check(not names or seen == {route},
              f"attention-bwd: bf16 D={D} dispatched to {route}, traced "
              f"{sorted(names)}")
        served[D] = f"{route}/{'traced' if names else 'trace-empty'}"
    # two bf16 calls at the train shape: the same gradient, bit for bit
    q, k, v, o, lse, do = case(bf16, TRAIN_B, 32, 8, TRAIN_S, 64, True, 0,
                               "causal")
    first = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    n += 3
    bit_same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(bit_same, "attention-bwd: two bf16 calls at the train shape "
                    "differ")
    # the fp32 forward on one input (the card test's autograd inputs),
    # FWD_REPEATS times: every output and lse the first call's, bit for bit
    gf = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=gf).to(dev) for s in
               ((2, 8, 70, 64), (2, 2, 70, 64), (2, 2, 70, 64)))
    o0, l0 = flash_attention(q, k, v, causal=True, window=24,
                             return_lse=True)
    differ = 0
    for _ in range(FWD_REPEATS):
        o, lse = flash_attention(q, k, v, causal=True, window=24,
                                 return_lse=True)
        differ += not (torch.equal(o, o0) and torch.equal(lse, l0))
    check(differ == 0, f"attention-bwd: {differ} of {FWD_REPEATS} fp32 "
                       f"forward calls differ from the first")
    # rows with no unmasked key: a window past the kv length
    q, k, v, do = (torch.randn(s, generator=g).to(dev) for s in
                   ((1, 4, 16, 64), (1, 2, 4, 64), (1, 2, 4, 64),
                    (1, 4, 16, 64)))
    o, lse = flash_attention(q, k, v, causal=False, window=2,
                             return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=False, window=2)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=False, window=2)
    check(bool(torch.isneginf(lse[:, :, 5:]).all())
          and bool((got[0][:, :, 5:] == 0).all())
          and all(bool(torch.isfinite(t).all()) for t in got)
          and _grad_err(got, want) <= BWD_TOL[torch.float32],
          "attention-bwd: a row with no key is not lse = -inf, dq = 0")
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    check(counts.get("flash_attention_bwd") == n + 1,
          f"attention-bwd: {counts} launches for {n + 1} calls")
    say("attention-bwd", calls=n + 1,
        bf16_route=",".join(f"D{d}:{r}" for d, r in served.items()),
        train_shape_bit_identical=bit_same,
        fp32_forward_repeats=FWD_REPEATS, fp32_forward_differ=differ,
        max_err_of_max_grad_fp32=f"{worst[str(torch.float32)][0]:.3e}",
        max_err_of_max_grad_bf16=f"{worst[str(torch.bfloat16)][0]:.3e}",
        gate=f"fp32<={BWD_TOL[torch.float32]},bf16<="
             f"{BWD_TOL[torch.bfloat16]}",
        max_lse_err_fp32=f"{worst[str(torch.float32)][1]:.3e}",
        max_lse_err_bf16=f"{worst[str(torch.bfloat16)][1]:.3e}",
        lse_gate=f"fp32<={LSE_TOL[torch.float32]},bf16<="
                 f"{LSE_TOL[torch.bfloat16]}")


def _train_steps(step, state, batches, label: str):
    """Run ``step`` over ``batches``; per step the device time (CUDA
    events) and the loss.  Returns (state, losses, step_ms)."""
    losses, step_ms = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, met = step(state, b)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(met["loss"]))
    check(all(np.isfinite(losses)), f"{label}: a loss is not finite: "
                                    f"{losses}")
    return state, losses, step_ms


def train_phase(args) -> dict:
    """llama3.2-1b at its published width: seeded fp32 parameters, bf16
    compute, remat on, AdamW (warmup 2), ``TRAIN_STEPS`` steps of
    ``make_batch(cfg, 8, 256, step)``; no checkpoint (the state is ~20 GB
    of fp32)."""
    from repro_torch.config import get_arch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import _build
    from repro_torch.models import common
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg = get_arch("llama3_2_1b")
    check(cfg.param_dtype == "float32" and cfg.compute_dtype == "bfloat16"
          and cfg.remat, f"train: {cfg.name} is not fp32 / bf16 / remat")
    opt = adamw.AdamWConfig(warmup_steps=TRAIN_WARMUP,
                            total_steps=TRAIN_STEPS + TRAIN_SERVE_BATCHES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = steps.init_state(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = steps.make_train_step(cfg, opt)
    batches = [make_batch(cfg, TRAIN_B, TRAIN_S, s, args.seed,
                          device="cuda") for s in range(TRAIN_STEPS)]
    _build.launch_counts.clear()
    with AttnRecorder(common) as rec:
        state, losses, step_ms = _train_steps(step, state, batches, "train")
    counts = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    check(losses[-1] < losses[0],
          f"train: the loss did not fall: {losses[0]} -> {losses[-1]}")
    # a step runs each layer's forward twice (remat recomputes it in the
    # backward) and its backward once
    check(counts.get("flash_attention") == 2 * L * TRAIN_STEPS
          and counts.get("flash_attention_bwd") == L * TRAIN_STEPS,
          f"train: kernel launches {counts} for {TRAIN_STEPS} steps of "
          f"{L} layers")
    steady = float(np.mean(step_ms[1:]))
    tokens = TRAIN_B * TRAIN_S
    train_profile(lambda: step(state, batches[-1]), steady)
    say("train", model=cfg.name, layers=L, d=cfg.d_model, vocab=cfg.vocab,
        batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS, remat=cfg.remat,
        init_s=f"{init_s:.3f}",
        step_ms=json.dumps([round(x, 3) for x in step_ms]).replace(" ", ""),
        step_ms_steady=f"{steady:.3f}",
        tokens_per_s=f"{tokens / steady * 1e3:.1f}",
        max_memory_allocated_mib=f"{peak / 2**20:.1f}",
        losses=json.dumps([round(x, 5) for x in losses]).replace(" ", ""),
        flash_attention_per_step=(counts.get("flash_attention", 0)
                                  / TRAIN_STEPS),
        flash_attention_bwd_per_step=(counts.get("flash_attention_bwd", 0)
                                      / TRAIN_STEPS),
        launches=json.dumps(counts, sort_keys=True).replace(" ", ""))
    return dict(cfg=cfg, state=state, step=step, counts=counts,
                calls=rec.calls, step_ms=steady)


def _train_group(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("dkdv_kernel", "dq_kernel", "delta_kernel")):
        return "flash_attention_bwd"
    if "flash_tc_kernel" in low or "flash_kernel" in low:
        return "flash_attention"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def train_profile(run_step, step_ms: float) -> dict:
    """One more train step under ``torch.profiler`` (device activity):
    the kernels' time by group (the GEMMs, the attention's forward and
    backward kernels, everything else), the device's busy time and its
    idle share against the steady step time, the top other kernels."""
    for _ in range(3):           # an empty trace is taken again
        durs = kernel_trace(run_step, 1)
        if durs:
            break
    groups = {"gemm": 0.0, "flash_attention": 0.0,
              "flash_attention_bwd": 0.0, "other": 0.0}
    for name, d in durs.items():
        groups[_train_group(name)] += sum(d) / 1e3
    busy = sum(groups.values())
    top = sorted(((sum(d) / 1e3, n[:40]) for n, d in durs.items()
                  if _train_group(n) == "other"), reverse=True)[:5]
    out = dict(device_busy_ms=busy, idle_share=1 - busy / step_ms,
               kernels=sum(len(d) for d in durs.values()),
               groups_ms={k: round(v, 3) for k, v in groups.items()},
               top_other_ms={n: round(t, 3) for t, n in top})
    say("train-profile", step_ms=f"{step_ms:.3f}",
        device_busy_ms=f"{busy:.3f}", idle_share=f"{out['idle_share']:.4f}",
        kernels=out["kernels"],
        groups_ms=json.dumps(out["groups_ms"]).replace(" ", ""),
        top_other_ms=json.dumps(out["top_other_ms"]).replace(" ", ""))
    return out


def train_serve_phase(args, train: dict) -> dict:
    """The sample store on the card feeds the trainer, and the trained
    parameters serve: ``SAMPLE_IDS`` sample ids ingested in plans of
    ``WIDTH``; an epoch taken at a held snapshot while ``SAMPLE_EXTRA``
    more arrive, checked against a host oracle; ``TRAIN_SERVE_BATCHES``
    batches of ``epoch_iterator`` into the full-width train step;
    ``retire_below`` and ``compact``; then the port's ``Engine`` on the
    trained parameters, 4 identical requests of 32 new tokens, which must
    give identical outputs."""
    from repro_torch.api import KEY_DOMAIN_HI
    from repro_torch.data.pipeline import (
        StreamingSampleStore, SyntheticCorpus, epoch_iterator)
    from repro_torch.kernels import _build
    from repro_torch.serve.engine import Engine, Request

    cfg = train["cfg"]
    rng = np.random.default_rng(args.seed + 11)
    total = SAMPLE_IDS + SAMPLE_EXTRA
    offsets = rng.integers(0, 1 << 30, total).astype(np.int32)
    ids = np.arange(total, dtype=np.int32)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    store = StreamingSampleStore(device="cuda")
    for i in range(0, SAMPLE_IDS, WIDTH):
        store.ingest(ids[i:i + WIDTH], offsets[i:i + WIDTH])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0

    # an epoch at a held snapshot while producers go on ingesting
    snap = store.epoch_view()
    for i in range(SAMPLE_IDS, total, WIDTH):
        store.ingest(ids[i:i + WIDTH], offsets[i:i + WIDTH])
    t0 = time.perf_counter()
    edges = np.linspace(0, SAMPLE_IDS, 9).astype(int)
    bounds = [(int(a), int(b) - 1) for a, b in zip(edges[:-1], edges[1:])]
    bounds[-1] = (bounds[-1][0], KEY_DOMAIN_HI)
    shards = store.read_shards(bounds, snap)
    epoch_s = time.perf_counter() - t0
    store.release(snap)
    got = [kv for page in shards for kv in page]
    check(got == list(zip(ids[:SAMPLE_IDS].tolist(),
                          offsets[:SAMPLE_IDS].tolist())),
          "pipeline: the held epoch differs from the host oracle")

    # the trainer consumes the live epoch (every id ingested so far)
    corpus = SyntheticCorpus(cfg.vocab, args.seed)
    it = epoch_iterator(store, corpus, cfg, B=TRAIN_B, S=TRAIN_S)
    try:
        batches = [next(it) for _ in range(TRAIN_SERVE_BATCHES)]
    finally:
        it.close()
    want = np.stack([corpus.tokens(TRAIN_S + 1, stream_seed=int(o))
                     for o in offsets[:TRAIN_B]])
    check(np.array_equal(batches[0]["tokens"].cpu().numpy(), want[:, :-1]),
          "pipeline: the first batch is not the first ids' corpus tokens")
    check(store.client.active_snapshots == 0,
          "pipeline: the epoch's snapshot was not released")
    state, losses, step_ms = _train_steps(train["step"], train["state"],
                                          batches, "train-serve")
    t0 = time.perf_counter()
    store.retire_below(SAMPLE_RETIRE)
    n_live = store.compact()
    live = store.live_count()
    retire_s = time.perf_counter() - t0
    check(n_live == live == total - SAMPLE_RETIRE,
          f"pipeline: {n_live} / {live} live after retire + compact, "
          f"want {total - SAMPLE_RETIRE}")

    # serve the trained parameters
    eng = Engine(cfg, state.params, n_slots=4, max_len=128, device="cuda")
    prompt = corpus.tokens(48, stream_seed=int(offsets[-1])).tolist()
    reqs = [Request(rid=i, prompt=list(prompt), max_new=32)
            for i in range(4)]
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(all(r.done and len(r.out) == 32 for r in reqs),
          "train-serve: a request did not finish")
    check(all(r.out == reqs[0].out for r in reqs),
          "train-serve: identical prompts gave different outputs")
    counts = dict(_build.launch_counts)
    for name in PASS_KERNELS + ("flash_attention", "flash_attention_bwd",
                                "decode_attention"):
        check(counts.get(name, 0) > 0,
              f"kernel {name} never ran on the pipeline / train-serve path")
    stats = store.client.stats
    say("pipeline", ids=SAMPLE_IDS, plan=WIDTH, extra=SAMPLE_EXTRA,
        ingest_s=f"{ingest_s:.3f}",
        ids_per_s=f"{SAMPLE_IDS / ingest_s:.1f}",
        epoch_readers=len(bounds), epoch_s=f"{epoch_s:.3f}",
        retired=SAMPLE_RETIRE, retire_compact_s=f"{retire_s:.3f}",
        live=live, grows=stats.get("grows", 0),
        launches=json.dumps({k: counts.get(k, 0) for k in STORE_KERNELS},
                            sort_keys=True).replace(" ", ""))
    say("train-serve", batches=TRAIN_SERVE_BATCHES,
        losses=json.dumps([round(x, 5) for x in losses]).replace(" ", ""),
        step_ms=json.dumps([round(x, 3) for x in step_ms]).replace(" ", ""),
        requests=len(reqs), new_tokens=sum(len(r.out) for r in reqs),
        serve_s=f"{serve_s:.3f}", outputs_identical=True,
        launches=json.dumps(counts, sort_keys=True).replace(" ", ""))
    del eng, state, train["state"]
    torch.cuda.empty_cache()
    return dict(counts=counts)


def _rel_norm(x, ref) -> float:
    return float((x - ref).norm()) / max(float(ref.norm()), 1e-30)


def train_cpu_equals_cuda(args) -> None:
    """One train step of llama3.2-1b at full width with 2 layers on the
    CPU (plain twins) and on the card (kernels), from the same weights
    and batch, in fp32 and in bf16 compute.

    fp32 holds the algorithm: loss and grad norm within rtol
    ``FP32_TOL``; per leaf the clipped gradient (``m / (1 - b1)`` after
    one step) within ``FP32_TOL`` in relative norm, and the update within
    ``TRAIN_UPDATE_TOL`` (Adam's first step divides each gradient by its
    own size: a gradient near 0 whose summation order differs moves its
    element's update by up to 2·lr).  bf16 is held to the run's own
    spread, as phase ``cpu==cuda-model`` does: the card's gradient and
    update may stand at most ``BF16_SPREAD`` times as far (relative norm,
    worst leaf) from the CPU's fp32 ones as the CPU's bf16 ones do, and
    its loss within ``TRAIN_BF16_LOSS`` of the fp32 loss."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import steps

    base = dataclasses.replace(get_arch("llama3_2_1b"), n_layers=2)
    params = TT.init(base, torch.Generator().manual_seed(args.seed))
    p0 = tree_leaves(params)
    opt = adamw.AdamWConfig(warmup_steps=TRAIN_WARMUP,
                            total_steps=TRAIN_STEPS)
    out = {}
    secs = {}
    for cdt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=cdt)
        step = steps.make_train_step(cfg, opt)
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev, copy=True), params)
            st = steps.TrainState(p, adamw.init(p), torch.zeros(
                (), dtype=torch.int32, device=dev))
            batch = make_batch(cfg, 2, 128, 0, args.seed, device=dev)
            t0 = time.perf_counter()
            st, met = step(st, batch)
            loss = float(met["loss"])
            secs[cdt, dev] = time.perf_counter() - t0
            check(np.isfinite(loss), f"train-cpu==cuda: {cdt} loss on {dev}")
            out[cdt, dev] = dict(
                loss=loss, gnorm=float(met["grad_norm"]),
                m=[m.cpu() for m in tree_leaves(st.opt.m)],
                d=[q.cpu() - q0 for q, q0 in zip(tree_leaves(st.params),
                                                 p0)])
            del st
    ref, c32 = out["float32", "cpu"], out["float32", "cuda"]
    for key in ("loss", "gnorm"):
        check(abs(c32[key] - ref[key]) <= FP32_TOL * abs(ref[key]),
              f"train-cpu==cuda: fp32 {key} {c32[key]} != {ref[key]}")
    m32 = max(_rel_norm(a, b) for a, b in zip(c32["m"], ref["m"]))
    d32 = max(_rel_norm(a, b) for a, b in zip(c32["d"], ref["d"]))
    check(m32 <= FP32_TOL, f"train-cpu==cuda: fp32 gradient off by {m32:.3e}"
                           f" (relative norm, worst leaf) > {FP32_TOL}")
    check(d32 <= TRAIN_UPDATE_TOL, f"train-cpu==cuda: fp32 update off by "
                                   f"{d32:.3e} > {TRAIN_UPDATE_TOL}")
    spread = {}
    for dev in ("cpu", "cuda"):
        o = out["bfloat16", dev]
        spread[dev] = (
            max(_rel_norm(a, b) for a, b in zip(o["m"], ref["m"])),
            max(_rel_norm(a, b) for a, b in zip(o["d"], ref["d"])),
            abs(o["loss"] - ref["loss"]) / abs(ref["loss"]))
    for i, what in enumerate(("gradient", "update")):
        check(spread["cuda"][i] <= BF16_SPREAD * spread["cpu"][i],
              f"train-cpu==cuda: the card's bf16 {what} stands "
              f"{spread['cuda'][i]:.3e} from fp32, more than {BF16_SPREAD}x"
              f" the CPU's {spread['cpu'][i]:.3e}")
    check(spread["cuda"][2] <= TRAIN_BF16_LOSS,
          f"train-cpu==cuda: bf16 loss {out['bfloat16', 'cuda']['loss']} "
          f"off the fp32 loss by {spread['cuda'][2]:.3e}")
    say("train-cpu==cuda", model=base.name, layers=base.n_layers, batch=2,
        seq=128, loss_fp32_cpu=f"{ref['loss']:.6f}",
        loss_fp32_cuda=f"{c32['loss']:.6f}",
        grad_norm_fp32_cpu=f"{ref['gnorm']:.6f}",
        grad_norm_fp32_cuda=f"{c32['gnorm']:.6f}",
        grad_err_fp32=f"{m32:.3e}", update_err_fp32=f"{d32:.3e}",
        gate_fp32=f"loss,gnorm,grad<={FP32_TOL},update<={TRAIN_UPDATE_TOL}",
        loss_bf16_cuda=f"{out['bfloat16', 'cuda']['loss']:.6f}",
        grad_from_fp32_bf16_cpu=f"{spread['cpu'][0]:.3e}",
        grad_from_fp32_bf16_cuda=f"{spread['cuda'][0]:.3e}",
        update_from_fp32_bf16_cpu=f"{spread['cpu'][1]:.3e}",
        update_from_fp32_bf16_cuda=f"{spread['cuda'][1]:.3e}",
        gate_bf16=f"cuda<={BF16_SPREAD}x_cpu,loss<={TRAIN_BF16_LOSS}",
        step_s=json.dumps({f"{c}/{d}": round(s, 3) for (c, d), s in
                           secs.items()}).replace(" ", ""))


def train_restart_phase(args) -> None:
    """Reduced llama3.2-1b on the card through ``run_with_restarts`` with
    a ``CheckpointManager`` under ``build/``: 12 steps uninterrupted, and
    the same 12 with crashes at steps 6 and 10 (checkpoints every 4).
    Losses and parameters agree at the JAX package's own tolerances
    (``tests/test_checkpoint_fault.py``: rtol 1e-5, atol 1e-6)."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import get_arch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.fault import run_with_restarts
    from repro_torch.kernels import _build
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import steps

    cfg = get_arch("llama3_2_1b").reduced()
    step = steps.make_train_step(cfg, adamw.AdamWConfig())
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    runs = {}
    _build.launch_counts.clear()
    for name, crash in (("a", []), ("b", [6, 10])):
        t0 = time.perf_counter()
        runs[name] = run_with_restarts(
            init_fn=lambda: steps.init_state(cfg, torch.Generator(
                device="cuda").manual_seed(args.seed)),
            step_fn=step,
            batch_fn=lambda s: make_batch(cfg, 2, 16, s, args.seed,
                                          device="cuda"),
            ckpt=CheckpointManager(TRAIN_CKPT_DIR / name, keep=3,
                                   async_write=False, device="cuda"),
            total_steps=12, ckpt_every=4, crash_at=crash)
        runs[name] += (time.perf_counter() - t0,)
    counts = dict(_build.launch_counts)
    (sa, ha, ta), (sb, hb, tb) = runs["a"], runs["b"]
    check(("restart", 6, 4) in hb and ("restart", 10, 8) in hb,
          f"train-restart: no restarts in {hb}")
    la = {s: l for k, s, l in ha if k == "step"}
    lb = [(s, l) for k, s, l in hb if k == "step"]
    check(len(lb) == 12 + 2 + 2, f"train-restart: {len(lb)} steps run")
    loss_err = max(abs(l - la[s]) / abs(la[s]) for s, l in lb)
    check(loss_err <= 1e-5, f"train-restart: losses differ by {loss_err}")
    perr = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(sa.params), tree_leaves(sb.params)))
    check(perr <= 1e-6, f"train-restart: parameters differ by {perr}")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    say("train-restart", model=cfg.name, steps=12, crash_at="6,10",
        ckpt_every=4, replayed=len(lb) - 12,
        max_loss_rel_err=f"{loss_err:.3e}", max_param_err=f"{perr:.3e}",
        bit_equal=bool(loss_err == 0 and perr == 0),
        gate="rtol=1e-5,atol=1e-6", run_a_s=f"{ta:.3f}", run_b_s=f"{tb:.3f}",
        launches=json.dumps(counts, sort_keys=True).replace(" ", ""))


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
            # clock tick that no WAL record carries (ROADMAP reference
            # fault R2)
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
    for name in PASS_KERNELS:
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

def attention_report(serve, train, train_serve) -> list:
    """The two attention kernels at the widest inputs the serve path gave
    them, and the flash backward at the train phase's; ``library_ms`` is
    one ``scaled_dot_product_attention`` call on the same inputs (GQA, and
    for decode q as one row with a length mask), for the backward SDPA's
    backward through autograd.  ``launches`` adds the serve path's, the
    train phase's and the train-serve phase's (``launches_by``)."""
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
        dev_ms, dev_by = device_ms(run)
        plain_ms = time_ms(plain, iters=5)
        library_ms = time_ms(lib)
        library_dev_ms, library_dev_by = device_ms(lib)
        flops = 4 * pairs * D
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / BF16_TC_FLOPS * 1e3
        src, replaces = KERNELS[name]
        by = {phase: res["counts"].get(name, 0) for phase, res in
              (("serve", serve), ("train", train),
               ("train-serve", train_serve))}
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(by.values()), launches_by=by, max_abs_err=err,
            ms=ms, device_ms=dev_ms, device_ms_by=dev_by, plain_ms=plain_ms,
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            library_ms=library_ms, library_device_ms=library_dev_ms,
            library_device_ms_by=library_dev_by))
        say("kernel", name=name, shape=shape, dtype=str(q.dtype),
            ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", device_ms_by=dev_by,
            plain_ms=f"{plain_ms:.5f}",
            bound_ms=f"{max(bound_bytes, bound_ops):.6f}",
            library_ms=f"{library_ms:.5f}",
            library_device_ms=f"{library_dev_ms:.5f}",
            library_device_ms_by=library_dev_by,
            max_abs_err=f"{err:.3e}",
            max_abs_err_fp32=f"{err32:.3e}")
    rows.append(attention_bwd_report(train, train_serve))
    return rows


def _kernels_ms(fn, calls: int = 20) -> dict:
    """Each kernel's mean device ms over ``calls`` calls of ``fn``, by
    its name cut to its innermost namespace and template arguments
    (``tc::dq_kernel<64, 64>``; a trace that comes back empty is taken
    again, up to three times)."""
    durs = {}
    for _ in range(3):
        durs = kernel_trace(fn, calls)
        if durs:
            break
    out = {}
    for name, d in durs.items():
        m = re.search(r"(\w+::\w+(?:<[^>]*>)?)\(", name)
        out[m.group(1) if m else name[:60]] = round(sum(d) / len(d) / 1e3,
                                                     5)
    return out


def attention_bwd_report(train, train_serve) -> dict:
    """The flash backward at the train phase's inputs (its q, k, v; o and
    lse from the forward kernel; a seeded dO): parity with
    ``attention_bwd_ref``, ``ms`` and ``device_ms``, each of its kernels'
    device ms, the achieved TFLOP/s of the 7 tile products it does over
    the unmasked pairs, the same inputs without the causal mask (twice
    the pairs), the plain twin's time, SDPA's backward through autograd
    (``library_ms``), and the bound: q, k, v, o, dO and lse read once and
    dq, dk, dv written once, against 2.5x the forward's tensor-core FLOPs
    (4 per unmasked pair and head dim) at 989 TFLOP/s."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    name = "flash_attention_bwd"
    _, a, kw = train["calls"]["flash_attention"]
    q, k, v = (t.contiguous() for t in a)
    causal, window = kw.get("causal", True), kw.get("window", 0)
    o, lse = flash_attention(q, k, v, causal=causal, window=window,
                             return_lse=True)
    g = torch.Generator(device=q.device).manual_seed(23)
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)

    def run():
        return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)

    def plain():
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    got, want = run(), plain()
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(got, want))
    rel = _grad_err(got, want)
    check(rel <= BWD_TOL[q.dtype], f"{name} != plain at the train "
                                   f"phase's inputs ({rel:.3e} of max)")
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=True)

    def lib():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    ms = time_ms(run)
    dev_ms, dev_by = device_ms(run)
    kernels_ms = _kernels_ms(run)
    plain_ms = time_ms(plain, iters=5)
    library_ms = time_ms(lib)
    library_dev_ms, library_dev_by = device_ms(lib)
    # the same inputs without the causal mask: twice the pairs
    o_nc, lse_nc = flash_attention(q, k, v, causal=False, window=window,
                                   return_lse=True)

    def run_nc():
        return flash_attention_bwd(q, k, v, o_nc, lse_nc, do, causal=False,
                                   window=window)
    nc_ms, _ = device_ms(run_nc)
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
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 4 * lse.numel()           # q, o, dO, dq; k, v, dk, dv; lse
    flops = 2.5 * 4 * pairs * D
    done_flops = 7 * 2 * pairs * D         # the 7 tile products it does
    tflops = done_flops / (dev_ms * 1e-3) / 1e12
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / BF16_TC_FLOPS * 1e3
    by = {"train": train["counts"].get(name, 0),
          "train-serve": train_serve["counts"].get(name, 0)}
    src, replaces = KERNELS[name]
    shape = f"B={B},H={H},KVH={KVH},Sq={Sq},Skv={Skv},D={D}"
    say("kernel", name=name, shape=shape, dtype=str(q.dtype),
        ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", device_ms_by=dev_by,
        plain_ms=f"{plain_ms:.5f}",
        bound_ms=f"{max(bound_bytes, bound_ops):.6f}",
        library_ms=f"{library_ms:.5f}",
        library_device_ms=f"{library_dev_ms:.5f}",
        library_device_ms_by=library_dev_by,
        max_abs_err=f"{err:.3e}", err_of_max_grad=f"{rel:.3e}",
        launches_per_step=by["train"] / TRAIN_STEPS,
        kernels_device_ms=json.dumps(kernels_ms).replace(" ", ""),
        tflops_7_products=f"{tflops:.1f}",
        noncausal_device_ms=f"{nc_ms:.5f}")
    return dict(
        name=name, route="cuda", source=src, replaces=replaces,
        launches=sum(by.values()), launches_by=by,
        launches_per_step=by["train"] / TRAIN_STEPS, max_abs_err=err,
        ms=ms, device_ms=dev_ms, device_ms_by=dev_by, plain_ms=plain_ms,
        kernels_device_ms=kernels_ms, tflops_7_products=tflops,
        noncausal_device_ms=nc_ms,
        bound_ms=max(bound_bytes, bound_ops),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        library_ms=library_ms, library_device_ms=library_dev_ms,
        library_device_ms_by=library_dev_by)


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
    from repro_torch.launch.mesh import make_host_mesh

    # fp32 products in full fp32 (the reference's precision), no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    card = probe()
    # the port's kernels and, with them, the card's latency probe
    secs = _build.build((*_build.SOURCES, LATENCY_PROBE))
    say("build", seconds=f"{max(secs.values()):.2f}",
        libraries=len(secs), dir=str(_build.BUILD_DIR))
    rng = np.random.default_rng(args.seed)
    parity_edge_cases(rng, np.random.default_rng(args.seed + 3),
                      torch.device("cuda"))
    main_res = main_path(args, api, rng)
    profile_plans(main_res.pop("db"), api, rng)
    sharded_res = sharded_phase(args, api)
    cpu_equals_cuda(args, api)
    cpu_equals_cuda(args, api, tag="sharded-cpu==cuda", seed=5, ramp=True,
                    make=lambda dev: api.Uruv.sharded(
                        api.ShardedConfig(
                            base=api.UruvConfig(**REDUCED_CFG),
                            key_hi=UNIVERSE),
                        make_host_mesh(SHARDS, device=dev)))
    lifecycle_phase(api, rng)
    serve_res = serve_phase(args, rng)
    model_cpu_equals_cuda(args)
    attention_bwd_phase(torch.device("cuda"))
    train_res = train_phase(args)
    train_serve_res = train_serve_phase(args, train_res)
    train_cpu_equals_cuda(args)
    train_restart_phase(args)
    facts = main_res["facts"]
    durability_phase(args, api, rng, card,
                     facts["n_ops"] / max(facts["apply_s"], 1e-9))
    lat = latencies(torch.device("cuda"))
    rows = (kernel_report(main_res, lat["hbm"])
            + attention_report(serve_res, train_res, train_serve_res)
            + search_positions_report(main_res, api, rng, lat["l2"]))
    for row in rows:
        row["sharded_launches"] = sharded_res["counts"].get(row["name"], 0)
    locate_report(main_res)
    say("done", seconds=f"{time.perf_counter() - t_all:.1f}", card=repr(card))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
