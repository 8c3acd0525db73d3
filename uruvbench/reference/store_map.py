"""A dense NumPy map over the key universe, with the store's clock.

The semantics are the paper's linearizable ordered map, batched as the
announce array: op ``i`` of a plan runs at timestamp ``ts + i`` and sees
every op before it.  INSERT and DELETE return the previous value
(``NOT_FOUND`` if the key was absent), SEARCH the current value, RANGE
the count of live keys in ``[k1, k2]`` (k2 is the op's value field) and
its page of (key, value) pairs in key order.  A NOP returns
``NOT_FOUND`` and changes nothing, but takes its timestamp like any op.

:meth:`StoreMap.apply` answers a run of CRUD ops at once by sorting them
by (key, position); :func:`sequential_apply` is the one-op-at-a-time
loop the tests hold it to.  The op codes and sentinels are the ADT's
public encoding, copied here so that nothing of the program is imported.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

OP_INSERT, OP_DELETE, OP_SEARCH, OP_NOP, OP_RANGE = 0, 1, 2, 3, 4
NOT_FOUND = -1
TOMBSTONE = -(2**31) + 1


class StoreMap:
    """Keys ``0 .. universe_hi`` mapped to int32 values or ``NOT_FOUND``,
    and a clock that every op advances by one."""

    def __init__(self, universe_hi: int):
        self.val = np.full(int(universe_hi) + 1, NOT_FOUND, np.int32)
        self.ts = 0

    # ------------------------------------------------------------- plans
    def apply(self, codes, keys, values
              ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
        """One announce array.  Returns ``(results, timestamps, pages)``:
        results and timestamps one a op, pages one ``[n, 2]`` int64 array
        a RANGE op, in announce order."""
        codes = np.asarray(codes, np.int32)
        keys = np.asarray(keys, np.int64)
        values = np.asarray(values, np.int64)
        n = len(codes)
        out = np.full(n, NOT_FOUND, np.int64)
        pages: List[np.ndarray] = []
        rng_pos = np.flatnonzero(codes == OP_RANGE)
        start = 0
        for pos in list(rng_pos) + [n]:
            seg = slice(start, pos)
            out[seg] = self._crud(codes[seg], keys[seg], values[seg])
            if pos < n:
                page = self.range(int(keys[pos]), int(values[pos]))
                out[pos] = len(page)
                pages.append(page)
            start = pos + 1
        ts = self.ts + np.arange(n, dtype=np.int64)
        self.ts += n
        return out, ts, pages

    def _crud(self, codes, keys, values) -> np.ndarray:
        """A run of INSERT / DELETE / SEARCH / NOP ops in announce order."""
        n = len(codes)
        out = np.full(n, NOT_FOUND, np.int64)
        live = np.flatnonzero(codes != OP_NOP)
        if not live.size:
            return out
        c, k, v = codes[live], keys[live], values[live]
        order = np.argsort(k, kind="stable")      # by key, then position
        c, k, v = c[order], k[order], v[order]
        m = len(k)
        idx = np.arange(m)
        first = np.ones(m, bool)
        first[1:] = k[1:] != k[:-1]
        group = np.maximum.accumulate(np.where(first, idx, 0))
        writes = (c == OP_INSERT) | (c == OP_DELETE)
        written = np.where(c == OP_INSERT, v, NOT_FOUND)
        last = np.maximum.accumulate(np.where(writes, idx, -1))
        before = np.concatenate([[-1], last[:-1]])
        mine = before >= group                    # an earlier write, same key
        got = np.where(mine, written[np.maximum(before, 0)], self.val[k])
        res = np.empty(m, np.int64)
        res[order] = got
        out[live] = res
        ends = np.flatnonzero(np.concatenate([k[1:] != k[:-1], [True]]))
        hit = last[ends] >= group[ends]
        self.val[k[ends[hit]]] = written[last[ends[hit]]]
        return out

    def range(self, k1: int, k2: int) -> np.ndarray:
        """The live (key, value) pairs of ``[k1, k2]`` in key order."""
        lo, hi = max(k1, 0), min(k2, len(self.val) - 1)
        if hi < lo:
            return np.zeros((0, 2), np.int64)
        v = self.val[lo:hi + 1]
        ks = np.flatnonzero(v != NOT_FOUND)
        return np.stack([ks + lo, v[ks].astype(np.int64)], 1)

    def advance(self, n: int) -> None:
        """``n`` ops that change nothing (read-only plans, NOP padding)."""
        self.ts += int(n)

    def live_items(self) -> np.ndarray:
        """Every live (key, value) pair in key order, ``[n, 2]`` int64."""
        ks = np.flatnonzero(self.val != NOT_FOUND)
        return np.stack([ks, self.val[ks].astype(np.int64)], 1)


def sequential_apply(state: dict, codes, keys, values) -> list:
    """The same semantics one op at a time over a dict: the plain loop
    that :meth:`StoreMap.apply` is tested against.  Returns one
    ``(result, page)`` a op (``page`` None but for RANGE)."""
    out = []
    for c, k, v in zip(np.asarray(codes).tolist(), np.asarray(keys).tolist(),
                       np.asarray(values).tolist()):
        if c == OP_RANGE:
            page = sorted((x, y) for x, y in state.items() if k <= x <= v)
            out.append((len(page), page))
            continue
        prev = state.get(k, NOT_FOUND) if c != OP_NOP else NOT_FOUND
        if c == OP_INSERT:
            state[k] = v
        elif c == OP_DELETE:
            state.pop(k, None)
        out.append((prev, None))
    return out
