"""Data pipeline: synthetic corpus + packing + Uruv streaming sample store.

A port of the JAX package's ``repro.data.pipeline``.  The sample store is
the paper's streaming-analytics use case verbatim (Sec 1: real-time
ingestion + consistent scans): producers INSERT samples as they arrive;
epoch readers take a SNAPSHOT and RANGEQUERY shard ranges — readers never
block producers and always see a consistent epoch.  It runs over the
port's ``Uruv`` client, on ``cuda`` by default (``device="cpu"`` for the
plain PyTorch path).

Determinism & fault tolerance: batches are a pure function of
(seed, step), so restart-after-crash resumes the stream exactly
(the checkpoint records the step).  ``SyntheticCorpus`` is a numpy copy
of the JAX package's: the same seeds give the same tokens, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import KEY_DOMAIN_HI, OpBatch, Uruv, UruvConfig
from repro_torch.config import ArchConfig
from repro_torch.core.store import resolve_device


# ---------------------------------------------------------------------------
# synthetic corpus (a Zipfian Markov chain -> learnable structure)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SyntheticCorpus:
    vocab: int
    seed: int = 0
    order_mod: int = 97

    def tokens(self, n: int, stream_seed: int) -> np.ndarray:
        """Deterministic pseudo-corpus: t_{i+1} = f(t_i) + noise."""
        rng = np.random.default_rng((self.seed, stream_seed))
        out = np.empty(n, np.int32)
        t = int(rng.integers(0, self.vocab))
        zipf_pool = (rng.zipf(1.5, size=4096) - 1) % self.vocab
        for i in range(n):
            out[i] = t
            if rng.random() < 0.75:
                t = (t * 31 + 17) % self.vocab          # deterministic bigram
            else:
                t = int(zipf_pool[int(rng.integers(0, 4096))])
        return out


def _lm_batch(toks: np.ndarray, dev) -> Dict[str, torch.Tensor]:
    """Next-token batch from ``toks`` [B, S + 1] (int32)."""
    B, S = toks.shape[0], toks.shape[1] - 1
    return {
        "tokens": torch.as_tensor(np.ascontiguousarray(toks[:, :-1]),
                                  device=dev),
        "labels": torch.as_tensor(np.ascontiguousarray(toks[:, 1:]),
                                  device=dev),
        "mask": torch.ones((B, S), dtype=torch.bool, device=dev),
    }


def make_batch(cfg: ArchConfig, B: int, S: int, step: int, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """Pure function of (cfg, step): the batch for one train step, as
    tensors on ``device`` (default cuda)."""
    dev = resolve_device(device)
    corpus = SyntheticCorpus(cfg.vocab, seed)
    if cfg.encoder_only:
        rng = np.random.default_rng((seed, step, 1))
        emb = rng.standard_normal((B, S, cfg.d_model), np.float32) * 0.5
        labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        mask = rng.random((B, S)) < 0.08        # masked-prediction positions
        return {
            "embeds": torch.as_tensor(emb, dtype=torch.float32, device=dev),
            "labels": torch.as_tensor(labels, device=dev),
            "mask": torch.as_tensor(mask, device=dev),
        }
    toks = corpus.tokens(B * (S + 1), stream_seed=step).reshape(B, S + 1)
    batch = _lm_batch(toks, dev)
    if cfg.vlm is not None:
        rng = np.random.default_rng((seed, step, 2))
        batch["patches"] = torch.as_tensor(
            rng.standard_normal(
                (B, cfg.vlm.n_patches, cfg.vlm.patch_dim)) * 0.5,
            dtype=torch.float32, device=dev)
    return batch


# ---------------------------------------------------------------------------
# Uruv-backed streaming sample store
# ---------------------------------------------------------------------------

class StreamingSampleStore:
    """Samples keyed by monotonically increasing id, values = corpus offsets.

    * ``ingest(ids, offsets)``     — producer INSERTs (wait-free bulk pass)
    * ``epoch_view()``             — snapshot ts for a consistent epoch
    * ``read_shard(lo, hi, snap)`` — RANGEQUERY a shard of sample ids
    * ``read_shards(bounds, snap)``— ALL epoch readers' shard ranges in ONE
                                     batched `bulk_range` device pass
    * ``retire_below(id)``         — DELETE consumed samples (tombstones);
                                     physical reclaim via compact()
    """

    def __init__(self, cfg: Optional[UruvConfig] = None, *, device=None):
        self.client = Uruv(cfg or UruvConfig(), device=device)

    @property
    def device(self) -> torch.device:
        return self.client.executor.device

    @property
    def store(self):
        """The current store snapshot (immutable; tests/inspection)."""
        return self.client.store

    def ingest(self, ids: np.ndarray, offsets: np.ndarray) -> None:
        self.client.apply(OpBatch.inserts(ids, offsets))

    def epoch_view(self) -> int:
        return self.client.acquire_snapshot()

    def release(self, snap: int) -> None:
        self.client.release_snapshot(snap)

    def read_shard(self, lo: int, hi: int, snap: int) -> List[Tuple[int, int]]:
        return self.read_shards([(lo, hi)], snap)[0]

    def read_shards(
        self, bounds: List[Tuple[int, int]], snap: int
    ) -> List[List[Tuple[int, int]]]:
        """Epoch fan-out: Q shard ranges answered in ONE device pass.

        Every reader's [lo, hi] interval resolves at the same registered
        snapshot, so all shards observe one consistent epoch regardless of
        concurrent ingest (the paper's streaming-analytics scan, batched
        across consumers instead of loop-per-consumer)."""
        return self.client.range_all(
            [lo for lo, _ in bounds], [hi for _, hi in bounds],
            snap, scan_leaves=32, max_rounds=8,
        )

    def retire_below(self, sample_id: int, batch_width: int = 256) -> None:
        with self.client.snapshot() as snap:
            items = self.read_shard(0, sample_id - 1, snap)
        ids = np.array([k for k, _ in items], np.int32)
        for i in range(0, len(ids), batch_width):
            self.client.apply(OpBatch.deletes(ids[i : i + batch_width]))

    def compact(self) -> int:
        return self.client.compact()

    def live_count(self) -> int:
        with self.client.snapshot() as snap:
            return len(self.read_shard(0, KEY_DOMAIN_HI, snap))


def epoch_iterator(
    store: StreamingSampleStore,
    corpus: SyntheticCorpus,
    cfg: ArchConfig,
    B: int,
    S: int,
    n_shards: int = 1,
    shard: int = 0,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Consume a consistent epoch of the sample store shard-by-shard; the
    batches land on the store's device."""
    snap = store.epoch_view()
    try:
        items = store.read_shard(0, KEY_DOMAIN_HI, snap)
        mine = [off for sid, off in items if sid % n_shards == shard]
        for i in range(0, len(mine) - B + 1, B):
            offs = mine[i : i + B]
            toks = np.stack(
                [corpus.tokens(S + 1, stream_seed=o) for o in offs]
            )
            yield _lm_batch(toks, store.device)
    finally:
        store.release(snap)
