"""What decides ``correct``: every answer held to the plain reference.

The reference (``uruvbench.reference.StoreMap``) is fed the same
generated keys and operations in announce order and works every answer
out again.  Each check counts the answers that differ, and each has the
limit 0: the store is exact.

* ``unanswered``: ops whose future never resolved (the closed loop;
  a plan loop has every answer or raises);
* ``value_mismatches``: CRUD results and RANGE counts;
* ``timestamp_mismatches``: each op's linearization timestamp;
* ``range_page_mismatches``: RANGE pages (keys and values, in order);
* ``misrouted_requests``: requests whose slice of a front-end plan is
  not their own ops (the closed loop only);
* ``live_item_mismatches``: the live (key, value) pairs at the end.

The program's outputs are read only to be judged.  The one thing taken
from the program is the front end's plan boundaries (its dispatch
log): how it batched the requests sets the timestamps (each plan is
NOP-padded to a power of two), and is checked against the requests.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from uruvbench.reference import OP_RANGE, StoreMap

CHECKS = ("unanswered", "value_mismatches", "timestamp_mismatches",
          "range_page_mismatches", "misrouted_requests",
          "live_item_mismatches")
LIMITS = {name: 0 for name in CHECKS}


def _pages_differ(codes, got_index, got_pages, want_pages) -> int:
    pos = np.flatnonzero(np.asarray(codes) == OP_RANGE)
    if list(np.asarray(got_index).tolist()) != pos.tolist():
        return len(pos)
    return sum(not np.array_equal(np.asarray(g, np.int64).reshape(-1, 2), w)
               for g, w in zip(got_pages, want_pages))


def check_plans(ref: StoreMap, records, counts: Dict[str, int]) -> None:
    """Plans the program answered one by one (the plan loops, and every
    loop's warm-up)."""
    for r in records:
        want, ts, pages = ref.apply(r.codes, r.keys, r.values)
        res = r.result
        if res is None:                 # no answer is a wrong answer
            counts["value_mismatches"] += len(r.codes)
            continue
        counts["value_mismatches"] += int(np.sum(
            np.asarray(res.values)[:len(want)] != want))
        counts["timestamp_mismatches"] += int(np.sum(
            np.asarray(res.timestamps)[:len(ts)] != ts))
        counts["range_page_mismatches"] += _pages_differ(
            r.codes, res.range_index, res.range_pages, pages)


def check_requests(ref: StoreMap, stream, futures, dispatch_log,
                   counts: Dict[str, int]) -> None:
    """The closed loop's requests, in submit order (the front end's
    linearization order), and their timestamps from its plan layout."""
    codes, keys, values, bounds = stream.taken()
    sizes = np.diff(bounds)
    base = ref.ts
    want, _, pages = ref.apply(codes, keys, values)
    done = np.fromiter((f.done for f in futures), bool, len(futures))
    counts["unanswered"] += int(sizes[~done].sum())
    res = [f.result() for f in futures if f.done]
    got = np.concatenate([r.values for r in res]) if res else np.zeros(0)
    counts["value_mismatches"] += int(np.sum(got != want[np.repeat(done, sizes)]))
    # RANGE pages, request by request, where the stream has any
    rng_of = np.concatenate([[0], np.cumsum(codes == OP_RANGE)])
    for i in np.flatnonzero(done & (rng_of[bounds[1:]] > rng_of[bounds[:-1]])):
        a, b = bounds[i], bounds[i + 1]
        r = futures[i].result()
        counts["range_page_mismatches"] += _pages_differ(
            codes[a:b], r.range_index, r.range_pages,
            pages[rng_of[a]:rng_of[b]])
    # each plan holds its requests' ops in submit order from its start,
    # and a request's op j runs at the plan's base + its offset + j
    index = {id(f): i for i, f in enumerate(futures)}
    start = np.full(len(futures), -1, np.int64)
    at = base
    for p, spans in dispatch_log:
        ids = np.fromiter((index[id(f)] for f, _, _ in spans), np.int64,
                          len(spans))
        offs = np.fromiter((a for _, a, _ in spans), np.int64, len(spans))
        ends = np.fromiter((b for _, _, b in spans), np.int64, len(spans))
        ops = np.concatenate([np.arange(bounds[i], bounds[i + 1])
                              for i in ids])
        n = len(ops)
        laid = (np.array_equal(offs, np.concatenate([[0], ends[:-1]]))
                and np.array_equal(ends - offs, sizes[ids]) and n <= len(p)
                and np.array_equal(p.codes[:n], codes[ops])
                and np.array_equal(p.keys[:n], keys[ops])
                and np.array_equal(p.values[:n], values[ops]))
        if not laid:
            counts["misrouted_requests"] += sum(
                not np.array_equal(p.keys[a:b], keys[bounds[i]:bounds[i + 1]])
                or not np.array_equal(p.codes[a:b],
                                      codes[bounds[i]:bounds[i + 1]])
                or not np.array_equal(p.values[a:b],
                                      values[bounds[i]:bounds[i + 1]])
                for i, (_, a, b) in zip(ids, spans))
        start[ids] = at + offs
        at += len(p)
    ref.ts = at
    if res:
        ts = np.concatenate([r.timestamps for r in res])
        first = np.repeat(start[done], sizes[done])
        within = np.arange(len(ts)) - np.repeat(
            np.concatenate([[0], np.cumsum(sizes[done])[:-1]]), sizes[done])
        counts["timestamp_mismatches"] += int(np.sum(ts != first + within))


def check_live(ref: StoreMap, items: np.ndarray,
               counts: Dict[str, int]) -> None:
    want = ref.live_items()
    got = np.asarray(items, np.int64).reshape(-1, 2)
    common, ig, iw = np.intersect1d(got[:, 0], want[:, 0],
                                    assume_unique=True, return_indices=True)
    counts["live_item_mismatches"] += int(
        len(got) + len(want) - 2 * len(common)
        + np.sum(got[ig, 1] != want[iw, 1]))


def wrong_ops(counts: Dict[str, int]) -> int:
    """Ops that failed: no answer, or a wrong value or page."""
    return sum(counts.get(k, 0) for k in (
        "unanswered", "value_mismatches", "range_page_mismatches"))


