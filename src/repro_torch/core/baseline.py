"""Non-versioned baseline store — the comparison point for the paper's
figures, ported from the JAX package's ``repro.core.baseline``.

  * ``FlatStore`` — one contiguous sorted array ("fat chunk" layout in the
    spirit of Braginsky-Petrank chunks): every batch merges into the whole
    array, O(n) data movement per update batch, and range queries read the
    *latest* values (not linearizable under interleaved updates).
  * ``range_query_validated`` — the multi-scan technique of Brown and Avni
    that the paper calls out as scaling poorly: scan twice, retry until two
    consecutive scans agree.

Every function has the JAX function's exact semantics, bit for bit: the
merge sorts by (key, rank) and the last entry of a key group wins (a new
entry beats an old one, a later row of the batch an earlier one),
tombstones and ``KEY_MAX`` rows are dropped, and compaction is stable.
Sort, ``searchsorted`` and gathers are PyTorch calls, as the JAX package
computes them outside any Pallas kernel: the baseline has no kernel of
its own.  Lookups rank with ``searchsorted(side="left")``, not the
``search_positions`` rank.
"""

# uruvlint: disable-file=layering-index; reason: the flat baseline IS a searchsorted over one sorted array (the JAX twin is the rule's allowed repro/core/baseline.py)
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from repro_torch.core.ref import KEY_MAX, NOT_FOUND, TOMBSTONE
from repro_torch.core.store import resolve_device


@dataclasses.dataclass
class FlatStore:
    keys: torch.Tensor   # int32 [N], sorted, KEY_MAX padded
    vals: torch.Tensor   # int32 [N]
    count: torch.Tensor  # int32 []
    capacity: int


def create(capacity: int = 1 << 16, device=None) -> FlatStore:
    """An empty store of ``capacity`` slots on ``device`` (default cuda)."""
    dev = resolve_device(device)
    return FlatStore(
        keys=torch.full((capacity,), KEY_MAX, dtype=torch.int32, device=dev),
        vals=torch.full((capacity,), NOT_FOUND, dtype=torch.int32,
                        device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        capacity=capacity,
    )


def _batch(store: FlatStore, t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.int32, device=store.keys.device)


def bulk_update(store: FlatStore, keys, values) -> FlatStore:
    """Merge a batch (INSERT, or DELETE via TOMBSTONE) — O(n + P) rebuild."""
    keys, values = _batch(store, keys), _batch(store, values)
    N = store.capacity
    all_keys = torch.cat([store.keys, keys])
    all_vals = torch.cat([store.vals, values])
    # one sort by (key, rank): the rank (old rows first, then the batch in
    # order) is the low 32 bits of an int64 sort key
    rank = torch.arange(all_keys.numel(), dtype=torch.int64,
                        device=keys.device)
    order = torch.argsort(all_keys.long() * (1 << 32) + rank)
    sk, sv = all_keys[order], all_vals[order]
    # keep the LAST entry of each key group; drop tombstones
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:-1] = sk[1:] != sk[:-1]
    keep = last & (sk < KEY_MAX) & (sv != TOMBSTONE)
    pick = torch.argsort((~keep).int(), stable=True)
    kept = keep[pick][:N]
    ck = torch.where(kept, sk[pick][:N], KEY_MAX)
    cv = torch.where(kept, sv[pick][:N], NOT_FOUND)
    return FlatStore(ck, cv, keep.sum(dtype=torch.int32), store.capacity)


def bulk_lookup(store: FlatStore, keys) -> torch.Tensor:
    """Latest value of each key, ``NOT_FOUND`` where absent (int32 [P])."""
    keys = _batch(store, keys)
    pos = torch.searchsorted(store.keys, keys, right=False)
    pos_c = pos.clamp_max(store.capacity - 1)
    hit = store.keys[pos_c] == keys
    return torch.where(hit & (keys < KEY_MAX), store.vals[pos_c],
                       NOT_FOUND)


def range_scan(store: FlatStore, k1: int, k2: int, *,
               max_results: int = 1024):
    """Single unvalidated scan of latest values (not linearizable):
    ``(keys, vals, count)``, padded with ``KEY_MAX`` / ``NOT_FOUND`` to
    ``max_results``."""
    dev = store.keys.device
    lo = torch.searchsorted(store.keys, _batch(store, [k1]), right=False)
    idx = lo + torch.arange(max_results, dtype=torch.int64, device=dev)
    idx_c = idx.clamp_max(store.capacity - 1)
    k = store.keys[idx_c]
    ok = (idx < store.count) & (k <= k2)
    keys = torch.where(ok, k, KEY_MAX)
    vals = torch.where(ok, store.vals[idx_c], NOT_FOUND)
    return keys, vals, ok.sum(dtype=torch.int32)


def range_query_validated(
    store_ref: Callable[[], FlatStore], k1: int, k2: int, *,
    max_results: int = 1024, max_retries: int = 16,
) -> Tuple[List[Tuple[int, int]], int]:
    """Brown-Avni style multi-scan: retry until two scans agree.

    ``store_ref`` is a zero-arg callable returning the *current* FlatStore
    (emulating a shared pointer under concurrent updates).  Returns
    (results, n_scans).  Under a quiescent store this is 2 scans; under
    heavy interleaved updates it retries — the cost the paper's MVCC design
    avoids.
    """
    prev = None
    for attempt in range(max_retries):
        k, v, c = range_scan(store_ref(), k1, k2, max_results=max_results)
        n = int(c)
        cur = list(zip(k[:n].tolist(), v[:n].tolist()))
        if prev is not None and cur == prev:
            return cur, attempt + 1
        prev = cur
    return prev, max_retries
