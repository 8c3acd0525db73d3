"""Async pipelined admission: coalesce client requests into batched plans.

A port of the JAX package's ``repro.serve.coalescer``; the behaviour and
the stats are the same.  One difference below the surface: the port's
``apply_nowait`` reads its pass's accept flag on the host when it
dispatches (ROADMAP: the sync-free pass), so the overlap of host work
with device work that the text below describes is not there yet; the
results, the rejection replay and the futures are.  Over a client whose
executor has no deferred dispatch (``Uruv.sharded``) the coalescer
degrades to coalesced synchronous plans (``stats["plans_sync"]``).

The paper's wait-free claim is about progress under heavy concurrent
traffic; this layer is where that traffic actually lands.  Many small
client requests (each a few CRUD/range ops) are admitted into a FIFO
queue, coalesced into power-of-two-bucketed `OpBatch` plans, and executed
with the host and the device overlapped:

  * plan N is dispatched with ``Uruv.apply_nowait`` — no host sync; the
    client adopts the speculative store immediately;
  * while the device executes N, the host drains the queue and builds and
    routes plan N+1 (numpy work, future bookkeeping) and dispatches it
    behind N — two plans in flight;
  * only when the pipeline is full (or a client blocks on its future) is
    the OLDEST plan settled: ``Uruv.confirm`` blocks on the accept flag
    (the deferred host sync), materialises per-client
    results, and resolves futures.  A rejected plan (capacity / leaf-batch
    overflow — atomic, store untouched) rolls the client back and replays
    that plan and every later unconfirmed plan through the synchronous
    ``apply`` path at the exact same announce timestamps, so pipelining is
    invisible in results.

Each client gets an :class:`OpFuture` that slices its ops out of the
batched result: values, found mask, per-op linearization timestamps, and
complete range pages are bit-exact with issuing the same coalesced plans
synchronously (property-tested).

Coalescing is SKEW-AWARE (contention-adapting trees, arXiv:1709.00722):
zipfian hot-key traffic is exactly where a fixed batch width/deadline
falls over — wide batches concentrate same-leaf structural updates
(leaf-batch rejections -> slow-path rounds) and pile same-key versions
into deep chains.  The admission policy therefore (a) halves its target
width whenever a plan is rejected and doubles it back only while plans run
clean with a backlog, and (b) estimates skew per drained segment (the
duplicate-key fraction) — hot traffic halves the effective width and
shortens the deadline so hot keys drain in many small linearization
steps instead of one conflicted pass.

RANGE-bearing requests coalesce too, but their plans execute through the
synchronous ``apply`` (their pagination loop is host-driven); the
coalescer drains the pipeline first so linearization order stays FIFO.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.api import OP_NOP, OpBatch, Result, Uruv


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Coalescing knobs (DESIGN.md Sec 12).

    ``start_width``/``min_width``/``max_width`` bound the adaptive target
    plan width (always a power of two — plans NOP-pad to ``pow2_width``,
    so jit shape buckets stay O(log max_width)).  ``base_deadline_s`` is
    how long the oldest queued request may wait for the batch to fill
    before dispatching a partial plan; under hot traffic (duplicate-key
    fraction of a drained segment > ``hot_dup_frac``) the deadline
    contracts by ``hot_deadline_scale`` and the effective width halves.
    ``inflight_depth`` is the number of unconfirmed plans kept in flight
    (2 = host builds N+1 while the device executes N).
    """

    start_width: int = 64
    min_width: int = 8
    max_width: int = 1024
    base_deadline_s: float = 2e-3
    hot_dup_frac: float = 0.5
    hot_deadline_scale: float = 0.25
    inflight_depth: int = 2


class OpFuture:
    """One client request's slice of a batched result.

    ``result()`` drives the coalescer until this request's plan has been
    dispatched and settled, then returns the per-request :class:`Result`
    (values / found / per-op timestamps / complete range pages, announce
    positions rebased to the request).  ``submit_t``/``done_t`` (host
    monotonic clock) bracket queueing + batching + execution — the
    tail-latency harness reads per-op latency off them; ``dispatch_t``
    is when the request's plan was formed (``submit_t`` to ``dispatch_t``
    is its wait in the queue).
    """

    __slots__ = ("_coalescer", "n_ops", "submit_t", "dispatch_t", "done_t",
                 "_result")

    def __init__(self, coalescer: "Coalescer", n_ops: int):
        self._coalescer = coalescer
        self.n_ops = n_ops
        self.submit_t = time.monotonic()
        self.dispatch_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self._result: Optional[Result] = None

    @property
    def done(self) -> bool:
        return self._result is not None

    def result(self) -> Result:
        while self._result is None:
            if not self._coalescer.pump(force=True):
                raise RuntimeError(
                    "coalescer made no progress with futures outstanding")
        return self._result

    def _resolve(self, result: Result) -> None:
        self._result = result
        self.done_t = time.monotonic()


@dataclasses.dataclass
class _Queued:
    future: OpFuture
    plan: OpBatch          # host arrays, builder-validated
    has_range: bool


@dataclasses.dataclass
class _InFlight:
    pending: object        # api.PendingPlan
    spans: List[Tuple[OpFuture, int, int]]


class Coalescer:
    """The admission pipeline over one `Uruv` client (module docstring).

    ``exclusive=True`` additionally donates the store pools into each pass
    (`donate_store`): only for a coalescer that exclusively owns its
    client's store buffers, and it caps the pipeline at ONE unconfirmed
    plan (a second speculative pass would consume the rollback buffers a
    rejected pass passes through) — host-build/device-execute overlap
    remains.
    """

    def __init__(self, db: Uruv, policy: AdmissionPolicy = AdmissionPolicy(),
                 *, exclusive: bool = False, record: bool = False):
        self.db = db
        self.policy = policy
        self.exclusive = exclusive
        self.queue: Deque[_Queued] = collections.deque()
        self.inflight: Deque[_InFlight] = collections.deque()
        self.target_width = policy.start_width
        self.dispatch_log: Optional[List[Tuple[OpBatch, List[Tuple[OpFuture, int, int]]]]] = \
            [] if record else None
        self._last_dup = 0.0
        self._queued_ops = 0
        # executors without a deferred dispatch (sharded) raise
        # NotImplementedError on first use; the coalescer then degrades
        # to coalesced synchronous plans for its whole life
        self._pipelined = True
        self._depth = max(1, 1 if exclusive else policy.inflight_depth)
        self.stats: Dict[str, int] = {
            "requests": 0, "ops": 0, "plans": 0, "plans_sync": 0,
            "plans_rejected": 0, "replays": 0, "padded_ops": 0,
            "max_queue_depth": 0, "hot_segments": 0,
        }

    # -------------------------------------------------------------- admission
    def submit(self, plan: OpBatch) -> OpFuture:
        """Admit one client request (an already-built `OpBatch`) and
        return its future.  Ops keep FIFO announce order across requests."""
        n = len(plan)
        if n == 0:
            raise ValueError("empty request")
        fut = OpFuture(self, n)
        has_range = bool(plan.range_positions.size)
        self.queue.append(_Queued(fut, plan, has_range))
        self._queued_ops += n
        self.stats["requests"] += 1
        self.stats["ops"] += n
        self.stats["max_queue_depth"] = max(self.stats["max_queue_depth"],
                                            len(self.queue))
        return fut

    # --------------------------------------------------------------- policy
    def _deadline_s(self) -> float:
        if self._last_dup > self.policy.hot_dup_frac:
            return self.policy.base_deadline_s * self.policy.hot_deadline_scale
        return self.policy.base_deadline_s

    def _effective_width(self) -> int:
        w = self.target_width
        if self._last_dup > self.policy.hot_dup_frac:
            w = max(self.policy.min_width, w // 2)
        return w

    def _adapt(self, rejected: bool) -> None:
        if rejected:
            self.target_width = max(self.policy.min_width,
                                    self.target_width // 2)
        elif (self._queued_ops >= self.target_width
              and self.target_width < self.policy.max_width):
            self.target_width *= 2

    def _note_skew(self, keys: np.ndarray, codes: np.ndarray) -> None:
        real = keys[codes != OP_NOP]
        if real.size:
            self._last_dup = 1.0 - len(np.unique(real)) / real.size
            if self._last_dup > self.policy.hot_dup_frac:
                self.stats["hot_segments"] += 1

    # ------------------------------------------------------------------ pump
    @tracing.spanned("serve.pump")
    def pump(self, force: bool = False, now: Optional[float] = None) -> bool:
        """One admission step: build the next plan from the queue head
        (host work that overlaps the in-flight device pass), settle the
        oldest in-flight plan if the pipeline is full, dispatch.  Returns
        False when there was nothing to do (queue below width with an
        unexpired deadline and nothing to force)."""
        now = time.monotonic() if now is None else now
        width = self._effective_width()
        if self.queue and (
            force or self._queued_ops >= width
            or now - self.queue[0].future.submit_t >= self._deadline_s()
        ):
            reqs = self._take(width)
            self._dispatch(reqs)
            return True
        if force and self.inflight:
            self._retire_oldest()
            return True
        return False

    def flush(self) -> None:
        """Dispatch everything queued and settle every in-flight plan, then
        close the client's group-commit window (``sync_durable``: one fsync
        for every plan a durable client logged and has not yet synced, so
        every resolved future is on disk) and run its lifecycle tick."""
        while self.queue or self.inflight:
            self.pump(force=True)
        self.db.sync_durable()
        self.db.lifecycle_tick()

    def _take(self, width: int) -> List[_Queued]:
        take = [self.queue.popleft()]
        total = take[0].future.n_ops
        while self.queue and total + self.queue[0].future.n_ops <= width:
            q = self.queue.popleft()
            take.append(q)
            total += q.future.n_ops
        self._queued_ops -= total
        return take

    # -------------------------------------------------------------- dispatch
    @tracing.spanned("serve.dispatch")
    def _form(self, reqs: List[_Queued]):
        """The plan of ``reqs`` and each request's span in it."""
        now = time.monotonic()
        spans: List[Tuple[OpFuture, int, int]] = []
        at = 0
        for q in reqs:
            q.future.dispatch_t = now
            spans.append((q.future, at, at + q.future.n_ops))
            at += q.future.n_ops
        if tracing.enabled():
            tracing.note_waits(now - np.fromiter(
                (q.future.submit_t for q in reqs), np.float64, len(reqs)))
        plan = OpBatch.concat(*[q.plan for q in reqs]).pad_to_pow2()
        self.stats["plans"] += 1
        self.stats["padded_ops"] += len(plan) - at
        # plan arrays are host numpy (built by OpBatch on the host)
        self._note_skew(np.asarray(plan.keys), np.asarray(plan.codes))
        if self.dispatch_log is not None:
            self.dispatch_log.append((plan, spans))
        return spans, plan

    def _dispatch(self, reqs: List[_Queued]) -> None:
        spans, plan = self._form(reqs)
        if self._pipelined and not any(q.has_range for q in reqs):
            while len(self.inflight) >= self._depth:
                self._retire_oldest()
            try:
                pending = self.db.apply_nowait(
                    plan, donate_store=self.exclusive)
            except NotImplementedError:
                self._pipelined = False
            else:
                self.inflight.append(_InFlight(pending, spans))
                return
        # host-driven pagination (RANGE) or a sync-only executor: drain
        # the pipeline (FIFO order), then one coalesced synchronous plan
        while self.inflight:
            self._retire_oldest()
        self.stats["plans_sync"] += 1
        self._materialize(spans, self.db.apply(plan))
        self._adapt(rejected=False)

    @tracing.spanned("serve.retire")
    def _retire_oldest(self) -> None:
        entry = self.inflight.popleft()
        res = self.db.confirm(entry.pending)
        if res is not None:
            self._materialize(entry.spans, res)
            self._adapt(rejected=False)
            return
        # atomic rejection: the client rolled back to the pre-plan store;
        # every unconfirmed plan behind it ran on speculative state and is
        # invalid too — replay all of them synchronously, in order, at the
        # timestamps the restored clock re-derives (bit-exact)
        self.stats["plans_rejected"] += 1
        self._adapt(rejected=True)
        replay = [entry] + list(self.inflight)
        self.inflight.clear()
        for e in replay:
            self.stats["replays"] += 1
            self._materialize(e.spans, self.db.apply(e.pending.batch))

    # ------------------------------------------------------------- futures
    @tracing.spanned("serve.materialize")
    def _materialize(self, spans, res: Result) -> None:
        """Slice the batched Result into per-request Results and resolve
        the futures.  Every field keeps the batch's values verbatim —
        only announce positions (range_index) rebase to the request."""
        values = np.asarray(res.values)
        found = np.asarray(res.found)
        ts = np.asarray(res.timestamps)
        rng_pos = np.asarray(res.range_index).tolist()
        rng_resume = np.asarray(res.range_resume)
        for fut, a, b in spans:
            idx, pages, resumes = [], [], []
            for j, pos in enumerate(rng_pos):
                if a <= pos < b:
                    idx.append(pos - a)
                    pages.append(res.range_pages[j])
                    resumes.append(int(rng_resume[j]))
            fut._resolve(Result(
                values=values[a:b],
                found=found[a:b],
                timestamps=ts[a:b],
                range_index=np.asarray(idx, np.int32),
                range_pages=tuple(pages),
                range_resume=np.asarray(resumes, np.int32),
            ))
