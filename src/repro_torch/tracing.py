"""Spans and counters of the port's host path.

    from repro_torch import tracing

    tracing.enable()
    db.apply(plan)                     # any calls into the program
    rec = tracing.take()               # spans, queue waits, counters
    tracing.disable()

**Spans** are named by layer (``serve.*``, ``api.*``, ``batch.*``,
``lifecycle.*``, ``store.*``, ``pages``, ``sync.<site>``,
``python.gc``) and recorded at plan granularity and below, never once a
request.  A record is ``(name, start_ns, end_ns, parent, plan_id)``:
times on the wall clock (``time.time_ns``, the clock a ``torch.profiler``
trace's ``baseTimeNanoseconds`` is on, so spans and device events share
one axis), ``parent`` the index of the enclosing span's record (-1 for
none) and ``plan_id`` the plan the span worked for (0 outside any).  A
plan id is given where a plan enters ``repro_torch.api``; a
``PendingPlan`` keeps its id, so its ``confirm`` and a replay of its
batch carry it too.  Tracing is off by default: :func:`span` then returns
one shared no-op object and records nothing.  Records stay in memory
until :func:`take`; nothing is written anywhere.  While tracing is on, a
``gc.callbacks`` hook records each collection of CPython's cyclic GC as a
``python.gc`` span.  The host path is single-threaded, and so is the
tracer.

**Counters** (:data:`counters`, always on): ``launch.<kernel>`` (each
CUDA kernel launch, also read as ``kernels._build.launch_counts``) and
``host_reads.<site>`` (each device-to-host read on the store's paths,
counted where it happens by :func:`host_read`, which also records a
``sync.<site>`` span while tracing is on).

**Queue waits**: the admission front end hands each dispatched plan's
waits (submit to dispatch, seconds) to :func:`note_waits` while tracing
is on.
"""

from __future__ import annotations

import collections
import functools
import gc
import itertools
import time
from collections.abc import MutableMapping
from typing import Dict, List, Optional

import numpy as np

counters: "collections.Counter[str]" = collections.Counter()

_on = False
_records: List[list] = []     # [name, start_ns, end_ns, parent record, plan]
_open: List[list] = []        # records of the spans now open, innermost last
_plan = 0                     # the plan the open spans work for
_plan_ids = itertools.count(1)
_waits: List[np.ndarray] = []
_base: "collections.Counter[str]" = collections.Counter()
_gc_start: Optional[int] = None


class CounterGroup(MutableMapping):
    """The counters under ``prefix``, by the rest of their names: a view
    of :data:`counters` (``launch_counts[k] += 1`` adds to
    ``counters[prefix + k]``; ``clear()`` clears this group alone)."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def __getitem__(self, key: str) -> int:
        return counters[self.prefix + key]

    def __setitem__(self, key: str, value: int) -> None:
        counters[self.prefix + key] = value

    def __delitem__(self, key: str) -> None:
        del counters[self.prefix + key]

    def __iter__(self):
        n = len(self.prefix)
        return iter([k[n:] for k in counters if k.startswith(self.prefix)])

    def __len__(self) -> int:
        return sum(1 for k in counters if k.startswith(self.prefix))


class _NoSpan:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "plan", "outer_plan")

    def __init__(self, name: str, plan: int):
        self.rec = [name, 0, 0, None, 0]
        self.plan = plan

    def __enter__(self):
        global _plan
        rec = self.rec
        self.outer_plan = _plan
        if self.plan:
            _plan = self.plan
        rec[3] = _open[-1] if _open else None
        rec[4] = _plan
        _records.append(rec)
        _open.append(rec)
        rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _plan
        self.rec[2] = time.time_ns()
        _open.pop()
        _plan = self.outer_plan
        return False


def span(name: str, plan: int = 0):
    """A context manager recording span ``name`` while tracing is on;
    ``plan`` (non-zero) makes it and every span beneath it carry that
    plan id."""
    return _Span(name, plan) if _on else NO_SPAN


def spanned(name: str):
    """Decorate a function so that each call is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, 0):
                return fn(*args, **kwargs)
        return traced
    return wrap


def new_plan() -> int:
    """A fresh plan id while tracing is on, else 0."""
    return next(_plan_ids) if _on else 0


def host_read(site: str, n: int = 1):
    """Count ``n`` device-to-host reads at ``site``
    (``counters["host_reads.<site>"]``); wrap the read in the returned
    context manager, which records a ``sync.<site>`` span while tracing
    is on."""
    counters["host_reads." + site] += n
    return _Span("sync." + site, 0) if _on else NO_SPAN


def note_waits(waits_s: np.ndarray) -> None:
    """Keep one plan's queue waits (seconds) while tracing is on."""
    if _on:
        _waits.append(np.asarray(waits_s, np.float64))


def enabled() -> bool:
    return _on


def _on_gc(phase: str, info: dict) -> None:
    global _gc_start
    if phase == "start":
        _gc_start = time.time_ns()
    elif _gc_start is not None:
        _records.append(["python.gc", _gc_start, time.time_ns(),
                         _open[-1] if _open else None, _plan])
        _gc_start = None


def enable() -> None:
    """Turn span recording on; :func:`take` starts counting from here."""
    global _on
    if not _on:
        _on = True
        _base.clear()
        _base.update(counters)
        gc.callbacks.append(_on_gc)


def disable() -> None:
    """Turn span recording off (kept records wait for :func:`take`)."""
    global _on, _gc_start
    if _on:
        _on = False
        _gc_start = None
        gc.callbacks.remove(_on_gc)


def take() -> Dict[str, object]:
    """Return and clear what was recorded since :func:`enable` or the last
    ``take``: ``spans`` (the records, finished spans only, in start
    order), ``waits_s`` (every queue wait, one array) and ``counters``
    (each counter's increase)."""
    global _records, _waits
    recs, waits = _records, _waits
    _records, _waits = [], []
    done = [r for r in recs if r[2]]
    at = {id(r): i for i, r in enumerate(done)}
    spans = [(r[0], r[1], r[2], at.get(id(r[3]), -1), r[4]) for r in done]
    grown = counters - _base
    _base.clear()
    _base.update(counters)
    return {"spans": spans,
            "waits_s": np.concatenate(waits) if waits else np.zeros(0),
            "counters": dict(grown)}


def self_ns(spans) -> List[int]:
    """Each span's self time: its duration minus the union of its
    children's intervals (``spans`` as :func:`take` returns them)."""
    kids: Dict[int, list] = collections.defaultdict(list)
    for name, a, b, parent, _ in spans:
        if parent >= 0:
            kids[parent].append((a, b))
    out = []
    for i, (name, a, b, _, _) in enumerate(spans):
        covered, end = 0, a
        for ca, cb in sorted(kids.get(i, ())):
            ca, cb = max(ca, end), min(cb, b)
            if cb > ca:
                covered += cb - ca
                end = cb
        out.append(b - a - covered)
    return out
