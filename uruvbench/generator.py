"""The one traffic generator: keys, plans and client requests from a seed.

Everything a cell sends is drawn here from ``--seed`` and the cell's two
data files: the configuration (key universe, prefill count, popularity)
and the traffic mix (``uruvbench/traffic/<mix>.json``: the loop shape,
plan width or client count, op shares, range width).  The same seed
gives the same keys, plans and request stream on every run; how the
program then batches requests is its own affair.

Op codes are the ADT's public encoding (``uruvbench.reference``), which
the program shares.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from uruvbench.reference import (
    OP_DELETE, OP_INSERT, OP_RANGE, OP_SEARCH,
)

VALUE_HI = 1 << 30        # inserted values: uniform in [1, VALUE_HI)
STREAMS = {"keys": 1, "prefill": 2, "plans": 3, "requests": 4, "warm": 5}


def stream(seed: int, name: str) -> np.random.Generator:
    """The generator of one named stream of a run (any whole seed)."""
    return np.random.default_rng([int(seed) % (1 << 64), STREAMS[name]])


class Keyspace:
    """Keys ``1 .. key_universe``; the prefill's distinct keys and values;
    the popularity that op keys are drawn with: uniform over the universe,
    or zipf over a hot set of keys the table holds, spread evenly over
    its key order (every stride-th resident key), their ranks drawn from
    the seed.  A popular key is one the store has, so the window measures
    a served table and not the first insertion of its hot keys; an even
    spread gives every seed the same layout of hot keys over leaves."""

    def __init__(self, config: dict, seed: int):
        self.hi = int(config["key_universe"])
        n = int(config["prefill_keys"])
        rng = stream(seed, "prefill")
        self.prefill_keys = (rng.choice(self.hi, n, replace=False)
                             + 1).astype(np.int32)
        self.prefill_values = rng.integers(1, VALUE_HI, n).astype(np.int32)
        pop = config.get("popularity", {"kind": "uniform"})
        self.kind = pop["kind"]
        if self.kind == "zipf":
            rk = stream(seed, "keys")
            n_hot = int(pop["hot_keys"])
            p = np.arange(1, n_hot + 1, dtype=np.float64) ** -float(pop["s"])
            self.p = p / p.sum()
            if not 0 < n_hot <= n:
                raise ValueError(f"{n_hot} hot keys of {n} resident ones")
            resident = np.sort(self.prefill_keys)
            stride = len(resident) // n_hot
            start = int(rk.integers(stride))
            self.hot = rk.permutation(resident[start::stride][:n_hot])
        elif self.kind != "uniform":
            raise ValueError(f"unknown key popularity {self.kind!r}")

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "zipf":
            return self.hot[rng.choice(len(self.hot), size=n, p=self.p)]
        return rng.integers(1, self.hi + 1, n).astype(np.int32)

    def range_starts(self, rng: np.random.Generator, n: int,
                     width: int) -> np.ndarray:
        return rng.integers(1, self.hi - width + 2, n).astype(np.int32)


def plan(rng: np.random.Generator, traffic: dict, keys: Keyspace
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One plan of ``traffic["width"]`` ops: exactly the mix's share of
    each kind, the CRUD ops in random order, then the RANGE ops (one CRUD
    segment and one RANGE segment, as the paper's announce array)."""
    w, mix = int(traffic["width"]), traffic["mix"]
    n_rng = round(w * mix.get("range", 0.0))
    n_ins = round(w * mix["insert"])
    n_del = round(w * mix["delete"])
    n_crud = w - n_rng
    codes = np.full(n_crud, OP_SEARCH, np.int32)
    codes[:n_ins] = OP_INSERT
    codes[n_ins:n_ins + n_del] = OP_DELETE
    rng.shuffle(codes)
    k = keys.sample(rng, n_crud)
    v = np.where(codes == OP_INSERT, rng.integers(1, VALUE_HI, n_crud), 0)
    rw = int(traffic.get("range_width", 1))
    k1 = keys.range_starts(rng, n_rng, rw)
    return (np.concatenate([codes, np.full(n_rng, OP_RANGE, np.int32)]),
            np.concatenate([k, k1]).astype(np.int32),
            np.concatenate([v, k1 + rw - 1]).astype(np.int32))


def read_only(codes, keys, values):
    """The same plan with every update made a SEARCH: the same widths and
    segments, and a table left as it was (warm-up)."""
    upd = (codes == OP_INSERT) | (codes == OP_DELETE)
    return (np.where(upd, OP_SEARCH, codes).astype(np.int32), keys,
            np.where(upd, 0, values).astype(np.int32))


class RequestStream:
    """Client requests of ``request_ops`` = [lo, hi] ops each, every op's
    kind drawn from the mix, in one fixed order; drawn in chunks of
    ``CHUNK`` requests (the first in set-up, the next when one runs out)."""

    CHUNK = 1 << 16

    def __init__(self, rng: np.random.Generator, traffic: dict,
                 keys: Keyspace):
        self.rng, self.traffic, self.keys = rng, traffic, keys
        self.chunks: list = []
        self.ci = self.ri = self.n_taken = 0
        self._extend()

    def _extend(self) -> None:
        lo, hi = self.traffic["request_ops"]
        mix = self.traffic["mix"]
        rng = self.rng
        sizes = rng.integers(int(lo), int(hi) + 1, self.CHUNK)
        n = int(sizes.sum())
        r = rng.random(n)
        edges = np.cumsum([mix["insert"], mix["delete"], mix["search"]])
        codes = np.select([r < edges[0], r < edges[1], r < edges[2]],
                          [OP_INSERT, OP_DELETE, OP_SEARCH],
                          OP_RANGE).astype(np.int32)
        k = self.keys.sample(rng, n)
        v = np.where(codes == OP_INSERT, rng.integers(1, VALUE_HI, n), 0)
        rw = int(self.traffic.get("range_width", 1))
        is_rng = codes == OP_RANGE
        k = np.where(is_rng, self.keys.range_starts(rng, n, rw), k)
        v = np.where(is_rng, k.astype(np.int64) + rw - 1, v)
        self.chunks.append((codes, k.astype(np.int32), v.astype(np.int32),
                            np.concatenate([[0], np.cumsum(sizes)])))

    def take(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The next request's ``(codes, keys, values)``."""
        if self.ci == len(self.chunks):
            self._extend()
        codes, k, v, b = self.chunks[self.ci]
        a, e = b[self.ri], b[self.ri + 1]
        self.ri += 1
        self.n_taken += 1
        if self.ri == len(b) - 1:
            self.ci, self.ri = self.ci + 1, 0
        return codes[a:e], k[a:e], v[a:e]

    def taken(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Every request taken so far, concatenated: codes, keys, values
        and the ``n_taken + 1`` op offsets of the requests."""
        parts, bounds, base, left = [], [np.zeros(1, np.int64)], 0, self.n_taken
        for codes, k, v, b in self.chunks:
            m = min(left, len(b) - 1)
            if m == 0:
                break
            e = int(b[m])
            parts.append((codes[:e], k[:e], v[:e]))
            bounds.append(base + b[1:m + 1])
            base, left = base + e, left - m
        cat = [np.concatenate([p[i] for p in parts]) if parts
               else np.zeros(0, np.int32) for i in range(3)]
        return cat[0], cat[1], cat[2], np.concatenate(bounds)
