"""The typed plan IR of the public API: `OpBatch`, `Result`, `RangePage`.

An `OpBatch` is the paper's announce array as ONE value: op i is
``codes[i]`` applied to ``keys[i]`` (k1 for RANGEQUERY) with
``values[i]`` (the inserted value, or k2 for RANGEQUERY).  Linearization
is announce order — op i runs at timestamp ``base_ts + i``.  Plans are
assembled on the host as numpy int32 arrays and cross to the device once,
inside the executor's pass.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.core.ref import (
    KEY_MAX, NOT_FOUND, TOMBSTONE,
    OP_DELETE, OP_INSERT, OP_NOP, OP_RANGE, OP_SEARCH,
)


def _np1d(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, np.int32))


def pow2_width(n: int) -> int:
    """The power-of-two shape bucket for a width-``n`` plan (>= 1)."""
    return 1 << max(0, int(n) - 1).bit_length() if n else 1


def check_keys(keys, what: str = "key") -> None:
    """Front-door key-domain guard: reject the two sentinels.

    ``KEY_MAX`` pads and ``KEY_MAX - 1`` is the kernels' internal pad
    value (valid keys are ``< KEY_MAX - 1``).  The store would accept
    either and then never find it, so the builders raise here, on the
    host, before any device work.
    """
    k = np.asarray(keys)
    if k.size and bool(np.any(k >= KEY_MAX - 1)):
        bad = int(k[np.asarray(k >= KEY_MAX - 1)].flat[0])
        raise ValueError(
            f"{what} {bad} is in the sentinel range [KEY_MAX-1, KEY_MAX] "
            f"(valid keys are < {KEY_MAX - 1}); the store would accept it "
            "and then silently never find it")


@dataclasses.dataclass
class OpBatch:
    """A typed announce array: ``codes[P]``, ``keys[P]``, ``values[P]``
    (int32 numpy).  For OP_RANGE, ``keys[i]`` is k1 and ``values[i]`` k2
    (inclusive).  Padded slots are ``(OP_NOP, KEY_MAX, 0)``."""

    codes: np.ndarray
    keys: np.ndarray
    values: np.ndarray
    # the plan id (``repro_torch.tracing``) of the PendingPlan this batch
    # was dispatched as (0: none), so a replay of the batch carries it
    plan_id: int = dataclasses.field(default=0, compare=False, repr=False)

    @classmethod
    def inserts(cls, keys, values) -> "OpBatch":
        """INSERT(keys[i], values[i]) for every i (values broadcastable)."""
        k = _np1d(keys)
        check_keys(k, "INSERT key")
        v = np.broadcast_to(_np1d(values), k.shape).astype(np.int32)
        return cls(np.full(k.shape, OP_INSERT, np.int32), k, v.copy())

    @classmethod
    def deletes(cls, keys) -> "OpBatch":
        k = _np1d(keys)
        check_keys(k, "DELETE key")
        return cls(np.full(k.shape, OP_DELETE, np.int32), k,
                   np.zeros(k.shape, np.int32))

    @classmethod
    def searches(cls, keys) -> "OpBatch":
        k = _np1d(keys)
        check_keys(k, "SEARCH key")
        return cls(np.full(k.shape, OP_SEARCH, np.int32), k,
                   np.zeros(k.shape, np.int32))

    @classmethod
    def ranges(cls, k1, k2) -> "OpBatch":
        """RANGEQUERY([k1[i], k2[i]]) — op i snapshots at its own timestamp."""
        a = _np1d(k1)
        check_keys(a, "RANGE k1")
        b = np.broadcast_to(_np1d(k2), a.shape).astype(np.int32)
        check_keys(b, "RANGE k2")
        return cls(np.full(a.shape, OP_RANGE, np.int32), a, b.copy())

    @classmethod
    def updates(cls, keys, values) -> "OpBatch":
        """Legacy (keys, values) update encoding: TOMBSTONE value ->
        DELETE, KEY_MAX key -> NOP, otherwise INSERT.  The internal pad
        sentinel KEY_MAX - 1 is rejected."""
        k = _np1d(keys)
        if k.size and bool(np.any(k == KEY_MAX - 1)):
            raise ValueError(
                f"update key {KEY_MAX - 1} is the internal pad sentinel "
                f"(valid keys are < {KEY_MAX - 1}; KEY_MAX pads to NOP)")
        v = np.broadcast_to(_np1d(values), k.shape).astype(np.int32)
        codes = np.where(
            k >= KEY_MAX, OP_NOP,
            np.where(v == TOMBSTONE, OP_DELETE, OP_INSERT),
        ).astype(np.int32)
        return cls(codes, k, v.copy())

    @classmethod
    def from_ops(cls, ops: Sequence[Tuple[int, int, int]]) -> "OpBatch":
        """From a list of (op_code, key, value) tuples (oracle encoding)."""
        arr = np.asarray(list(ops), np.int32).reshape(-1, 3)
        check_keys(arr[:, 1][arr[:, 0] != OP_NOP], "key")
        check_keys(arr[:, 2][arr[:, 0] == OP_RANGE], "RANGE k2")
        return cls(arr[:, 0].copy(), arr[:, 1].copy(), arr[:, 2].copy())

    @classmethod
    def empty(cls) -> "OpBatch":
        z = np.zeros((0,), np.int32)
        return cls(z, z.copy(), z.copy())

    @classmethod
    def concat(cls, *batches: "OpBatch") -> "OpBatch":
        """Concatenate plans in announce order."""
        if not batches:
            return cls.empty()
        return cls(np.concatenate([b.codes for b in batches]),
                   np.concatenate([b.keys for b in batches]),
                   np.concatenate([b.values for b in batches]))

    def pad_to(self, width: int) -> "OpBatch":
        """Pad with NOPs to ``width``."""
        n = len(self)
        if width < n:
            raise ValueError(f"pad_to({width}) below batch width {n}")
        if width == n:
            return self
        r = width - n
        return OpBatch(
            np.concatenate([self.codes, np.full((r,), OP_NOP, np.int32)]),
            np.concatenate([self.keys, np.full((r,), KEY_MAX, np.int32)]),
            np.concatenate([self.values, np.zeros((r,), np.int32)]),
        )

    def pad_to_pow2(self) -> "OpBatch":
        """NOP-pad to the next power-of-two width (``pow2_width``)."""
        return self.pad_to(pow2_width(len(self)))

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    @property
    def range_positions(self) -> np.ndarray:
        """Announce positions of the RANGE ops."""
        return np.nonzero(self.codes == OP_RANGE)[0]


@dataclasses.dataclass
class RangePage:
    """One bounded range-scan pass over Q intervals (rows key-sorted);
    the fields are tensors on the store's device.  ``truncated[q]`` means
    interval q was not fully covered: re-enter from ``resume_k1[q]``."""

    keys: "object"        # int32 [Q, R], KEY_MAX padded
    values: "object"      # int32 [Q, R], NOT_FOUND padded
    count: "object"       # int32 [Q]
    truncated: "object"   # bool  [Q]
    resume_k1: "object"   # int32 [Q]

    def items(self, q: int = 0) -> List[Tuple[int, int]]:
        """Query q's (key, value) page as a host list."""
        c = int(self.count[q])
        k = self.keys[q, :c].cpu().numpy()
        v = self.values[q, :c].cpu().numpy()
        return list(zip(k.tolist(), v.tolist()))


@dataclasses.dataclass
class Result:
    """Per-op outcome of ``Uruv.apply`` in announce order (host numpy).

    * ``values[i]``     — INSERT/DELETE: previous value (NOT_FOUND if new);
                          SEARCH: value at the op's snapshot; RANGE: number
                          of live keys in [k1, k2] at the op's snapshot;
                          NOP/padded: NOT_FOUND.
    * ``found[i]``      — ``values[i] != NOT_FOUND`` (and not a NOP).
    * ``timestamps[i]`` — the op's linearization timestamp (base_ts + i).
    * ``range_index``   — announce positions of the RANGE ops, in order.
    * ``range_pages``   — one ``[n_q, 2]`` (key, value) array per RANGE op.
    * ``range_resume``  — per RANGE op, the frontier after the answered
                          pages (k2 for a complete answer).
    """

    values: np.ndarray
    found: np.ndarray
    timestamps: np.ndarray
    range_index: np.ndarray
    range_pages: Tuple[np.ndarray, ...]
    range_resume: np.ndarray

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def page(self, announce_pos: int) -> List[Tuple[int, int]]:
        """The (key, value) page of the RANGE op at ``announce_pos``."""
        idx = self.range_index.tolist()
        arr = self.range_pages[idx.index(int(announce_pos))]
        return [(int(k), int(v)) for k, v in arr]

    def pages(self) -> List[List[Tuple[int, int]]]:
        """All RANGE pages, in announce order of the RANGE ops."""
        return [[(int(k), int(v)) for k, v in p] for p in self.range_pages]

    @property
    def value(self) -> int:
        """Scalar convenience for single-op batches."""
        if len(self) != 1:
            raise ValueError("Result.value requires a single-op batch")
        return int(self.values[0])


def make_result(
    values: np.ndarray,
    codes: np.ndarray,
    base_ts: int,
    range_items: Iterable[Tuple[int, List[Tuple[int, int]], int]] = (),
) -> Result:
    """Assemble a Result from executor outputs; ``range_items`` yields
    (announce_pos, page, resume_k1) per RANGE op."""
    values = np.asarray(values, np.int64)
    codes = np.asarray(codes, np.int32)
    n = len(values)
    idx, pages, resumes = [], [], []
    if range_items:
        with tracing.span("pages"):
            for pos, page, resume in range_items:
                idx.append(pos)
                pages.append(np.asarray(page, np.int32).reshape(-1, 2))
                resumes.append(resume)
    return Result(
        values=values,
        found=(values != NOT_FOUND) & (codes != OP_NOP),
        timestamps=(base_ts + np.arange(n)).astype(np.int32),
        range_index=np.asarray(idx, np.int32),
        range_pages=tuple(pages),
        range_resume=np.asarray(resumes, np.int32),
    )
