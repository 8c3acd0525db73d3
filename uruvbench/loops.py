"""The window's loop shapes, chosen by a traffic file's ``loop`` key.

* ``plans``: one client sends plans of ``width`` ops, synchronously
  through ``Uruv.apply`` (``inflight`` 1), or pipelined through
  ``Uruv.apply_nowait`` / ``confirm`` with ``inflight`` plans out, a
  rejected plan and every later one replayed through ``apply`` as the
  program's own front end does.  An op's latency is its plan's, from the
  call to its result on the host.
* ``closed_loop``: ``clients`` clients, each keeping one request out
  through the admission front end (``repro_torch.serve.coalescer``): a
  client whose answer came sends the stream's next request.  An op's
  latency is its request's, from ``submit`` to the future's result.

Each loop keeps what the reference needs to judge every answer, and
counts ops, plans and the program's counters over the window.  What it
keeps makes every full collection of CPython's cyclic GC scan a heap
that grows through the window (millions of futures and results in the
closed loop: 6.8-7.1 s of a 40 s window in full collections), so the
window runs without full collections (:func:`young_gc_only`); the
program's young garbage is collected as before.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
from typing import Any, List

import numpy as np

from uruvbench import compare
from uruvbench.generator import (
    Keyspace, RequestStream, plan, read_only, stream,
)
from uruvbench.reference import OP_INSERT, OP_SEARCH

WARM_PLANS = 2            # read-only plans a warmed entry and width


@dataclasses.dataclass
class PlanRecord:
    """One plan handed to the program after the prefill, in announce
    order, and what came back."""

    codes: np.ndarray
    keys: np.ndarray
    values: np.ndarray
    result: Any = None          # api.Result; None: never answered
    t_issue: float = 0.0
    t_done: float = float("inf")
    window: bool = False        # issued inside the measured window
    traced: bool = False        # issued while the device trace ran


@contextlib.contextmanager
def young_gc_only():
    """The cyclic GC's first two generations only: no full collection
    until the block ends (its threshold restored, one collection run)."""
    t0, t1, t2 = gc.get_threshold()
    gc.set_threshold(t0, t1, 1 << 30)
    try:
        yield
    finally:
        gc.set_threshold(t0, t1, t2)
        gc.collect()


def stats_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def prefill(db, api, keys: Keyspace, width: int) -> None:
    """Insert the configuration's prefill keys in plans of ``width``,
    ramped on the empty store (a third of the keys already in, from 64
    up), where the slow path would otherwise halve them."""
    ks, vs = keys.prefill_keys, keys.prefill_values
    i = 0
    while i < len(ks):
        w = min(width, max(64, i // 3) // 4 * 4)
        k = ks[i:i + w]
        db.apply(api.OpBatch(np.full(len(k), OP_INSERT, np.int32), k,
                             vs[i:i + w]))
        i += len(k)


class PlanLoop:
    checks = tuple(c for c in compare.CHECKS
                   if c not in ("unanswered", "misrouted_requests"))

    def __init__(self, db, api, traffic: dict, config: dict, keys: Keyspace,
                 seed: int):
        self.db, self.api, self.traffic, self.keys = db, api, traffic, keys
        self.width = int(traffic["width"])
        self.depth = int(traffic.get("inflight", 1))
        if self.depth > 1 and traffic["mix"].get("range", 0.0) > 0:
            raise ValueError("pipelined plans are CRUD-only (apply_nowait)")
        self.seed = seed
        self.rng = stream(seed, "plans")
        self.records: List[PlanRecord] = []
        self.prefill_width = self.width

    def _batch(self, rec: PlanRecord):
        return self.api.OpBatch(rec.codes, rec.keys, rec.values)

    def warm(self) -> None:
        """The cell's own width through the cell's own entries, read-only
        (the table is left as it was)."""
        rng = stream(self.seed, "warm")
        for _ in range(WARM_PLANS):
            rec = PlanRecord(*read_only(*plan(rng, self.traffic, self.keys)))
            rec.result = self.db.apply(self._batch(rec))
            self.records.append(rec)
            if self.depth > 1:
                rec = PlanRecord(*read_only(*plan(rng, self.traffic,
                                                  self.keys)))
                rec.result = self.db.confirm(
                    self.db.apply_nowait(self._batch(rec)))
                self.records.append(rec)

    def run(self, seconds: float, tr) -> dict:
        db = self.db
        before = dict(db.stats)
        inflight: collections.deque = collections.deque()
        self.rejected = 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        n_plans = traced = 0
        while time.perf_counter() < t_end:
            if tr.due():
                tr.stop()
            with tr.span("plan_build"):
                rec = PlanRecord(*plan(self.rng, self.traffic, self.keys),
                                 window=True, traced=tr.active)
                batch = self._batch(rec)
            n_plans += 1
            traced += rec.traced
            self.records.append(rec)
            rec.t_issue = time.perf_counter()
            if self.depth == 1:
                with tr.span("apply"):
                    rec.result = db.apply(batch)
                rec.t_done = time.perf_counter()
                continue
            with tr.span("dispatch"):
                pending = db.apply_nowait(batch)
            inflight.append((pending, rec))
            if len(inflight) >= self.depth:
                self._settle(inflight, tr)
        counters = stats_delta(db.stats, before)
        if tr.active:
            tr.stop()
        while inflight:
            self._settle(inflight, tr)
        win = [r for r in self.records if r.window]
        done = [r for r in win if r.t_done <= t_end]
        timeline = _timeline([r.t_done - t_start for r in done],
                             [len(r.codes) for r in done], seconds)
        lat = np.concatenate([np.full(len(r.codes), r.t_done - r.t_issue)
                              for r in done]) if done else np.zeros(0)
        return dict(
            attempted=sum(len(r.codes) for r in win),
            ops_done=int(lat.size), latencies_s=lat, plans=n_plans,
            plans_traced=traced, uruv=counters, coalescer=None,
            first_s=[r.t_done - r.t_issue for r in win[:3]],
            timeline=timeline,
            traced=[(r.codes, r.keys, _range_pairs(r.result))
                    for r in win if r.traced],
            rejected=self.rejected)

    def _settle(self, inflight, tr) -> None:
        pending, rec = inflight.popleft()
        with tr.span("confirm"):
            res = self.db.confirm(pending)
        if res is not None:
            rec.result, rec.t_done = res, time.perf_counter()
            return
        # the pass was rejected and the client rolled back: this plan and
        # every later one ran on speculative state; replay them in order
        self.rejected += 1
        replay = [(pending, rec)] + list(inflight)
        inflight.clear()
        for p, r in replay:
            with tr.span("replay"):
                r.result = self.db.apply(p.batch)
            r.t_done = time.perf_counter()


    def check(self, ref, counts) -> None:
        compare.check_plans(ref, self.records, counts)


def _timeline(at_s, ops, seconds: float, parts: int = 8) -> list:
    """Ops completed in each eighth of the window."""
    edges = np.linspace(0.0, seconds, parts + 1)
    return np.histogram(at_s, edges, weights=ops)[0].astype(int).tolist()


def _range_pairs(result) -> int:
    if result is None:
        return 0
    return int(sum(len(p) for p in result.range_pages))


class ClosedLoop:
    checks = compare.CHECKS

    def __init__(self, db, api, traffic: dict, config: dict, keys: Keyspace,
                 seed: int):
        from repro_torch.serve.coalescer import AdmissionPolicy

        self.db, self.api, self.traffic, self.keys = db, api, traffic, keys
        self.seed = seed
        self.policy = AdmissionPolicy(**config.get("admission", {}))
        self.clients = int(traffic["clients"])
        self.stream = RequestStream(stream(seed, "requests"), traffic, keys)
        self.records: List[PlanRecord] = []
        self.futures: List[Any] = []
        self.coalescer = None
        self.prefill_width = self.policy.max_width

    def warm(self) -> None:
        """Every plan width the front end can form (powers of two up to
        its ``max_width``), read-only, through ``apply_nowait`` /
        ``confirm`` and through ``apply`` (its replays)."""
        rng = stream(self.seed, "warm")
        w = 1
        while w <= self.policy.max_width:
            for _ in range(WARM_PLANS):
                k = self.keys.sample(rng, w)
                rec = PlanRecord(np.full(w, OP_SEARCH, np.int32), k,
                                 np.zeros(w, np.int32))
                rec.result = self.db.confirm(self.db.apply_nowait(
                    self.api.OpBatch(rec.codes, rec.keys, rec.values)))
                self.records.append(rec)
                rec = PlanRecord(rec.codes, rec.keys, rec.values)
                rec.result = self.db.apply(
                    self.api.OpBatch(rec.codes, rec.keys, rec.values))
                self.records.append(rec)
            w *= 2

    def run(self, seconds: float, tr) -> dict:
        from repro_torch.serve.coalescer import Coalescer

        db, api = self.db, self.api
        c = self.coalescer = Coalescer(db, self.policy, record=True)
        before = dict(db.stats)
        pending: collections.deque = collections.deque()
        futs = self.futures

        def submit():
            fut = c.submit(api.OpBatch(*self.stream.take()))
            futs.append(fut)
            pending.append(fut)

        t_start = time.monotonic()
        t_end = t_start + seconds
        trace_plans = [0, None]
        with tr.span("submit"):
            for _ in range(self.clients):
                submit()
        while time.monotonic() < t_end:
            if tr.due():
                trace_plans[1] = c.stats["plans"]
                tr.stop()
            with tr.span("pump"):
                if not c.pump():
                    c.pump(force=True)
            with tr.span("collect"):
                n = 0
                while pending and pending[0].done:
                    pending.popleft()
                    n += 1
                for _ in range(n):
                    submit()
        counters = stats_delta(db.stats, before)
        at_close = dict(c.stats)
        if tr.active:
            trace_plans[1] = c.stats["plans"]
            tr.stop()
        c.flush()
        done = [f for f in futs if f.done_t is not None and f.done_t <= t_end]
        timeline = _timeline([f.done_t - t_start for f in done],
                             [f.n_ops for f in done], seconds)
        lat = (np.repeat([f.done_t - f.submit_t for f in done],
                         [f.n_ops for f in done]) if done else np.zeros(0))
        traced = []
        if trace_plans[1] is not None:
            for p, spans in c.dispatch_log[trace_plans[0]:trace_plans[1]]:
                pairs = sum(_range_pairs(f._result) for f, _, _ in spans)
                traced.append((p.codes, p.keys, pairs))
        return dict(
            attempted=sum(f.n_ops for f in futs), ops_done=int(lat.size),
            latencies_s=lat, plans=at_close["plans"],
            plans_traced=len(traced), uruv=counters, coalescer=at_close,
            first_s=[f.done_t - f.submit_t for f in futs[:1] if f.done],
            timeline=timeline,
            traced=traced, rejected=at_close["plans_rejected"])


    def check(self, ref, counts) -> None:
        compare.check_plans(ref, self.records, counts)       # the warm-up
        compare.check_requests(ref, self.stream, self.futures,
                               self.coalescer.dispatch_log, counts)


LOOPS = {"plans": PlanLoop, "closed_loop": ClosedLoop}
