"""The port's data pipeline against the JAX package's, on the CPU.

Mirrors the pipeline cases of ``tests/test_data_serve.py``: the corpus
and ``make_batch`` are bit-equal to JAX's (the same numpy draws), and the
streaming sample store — a port ``Uruv`` beside a JAX ``Uruv``, fed the
same ingests, epoch reads, retirements and compaction — holds bit-equal
store arrays at every stage and gives the same answers.
"""

import dataclasses

import numpy as np
import pytest

from repro.config import VLMConfig as JVLMConfig
from repro.config import get_arch as j_get_arch
from repro.data import pipeline as JP

from repro_torch.config import VLMConfig, get_arch
from repro_torch.core.store import to_numpy
from repro_torch.data import pipeline as TP

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    assert_same_arrays, bounded_jax_maps, fresh_jax_caches, jax_arrays,
)


def _cfgs(kind: str):
    jcfg = j_get_arch("llama3_2_1b").reduced()
    cfg = get_arch("llama3_2_1b").reduced()
    if kind == "encoder":
        jcfg = dataclasses.replace(jcfg, encoder_only=True)
        cfg = dataclasses.replace(cfg, encoder_only=True)
    elif kind == "vlm":
        jcfg = dataclasses.replace(jcfg, vlm=JVLMConfig(patch_dim=24,
                                                        n_patches=4))
        cfg = dataclasses.replace(cfg, vlm=VLMConfig(patch_dim=24,
                                                     n_patches=4))
    return jcfg, cfg


def _same_batch(jb, tb):
    assert sorted(jb) == sorted(tb)
    for k in jb:
        a, b = np.asarray(jb[k]), tb[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("kind", ["lm", "encoder", "vlm"])
@pytest.mark.parametrize("B,S,step,seed", [(2, 16, 5, 0), (3, 9, 0, 7)])
def test_make_batch_matches_jax(kind, B, S, step, seed):
    jcfg, cfg = _cfgs(kind)
    _same_batch(JP.make_batch(jcfg, B, S, step, seed),
                TP.make_batch(cfg, B, S, step, seed, device="cpu"))


def test_make_batch_deterministic():
    _, cfg = _cfgs("lm")
    b1 = TP.make_batch(cfg, 2, 16, step=5, device="cpu")
    b2 = TP.make_batch(cfg, 2, 16, step=5, device="cpu")
    b3 = TP.make_batch(cfg, 2, 16, step=6, device="cpu")
    assert (b1["tokens"] == b2["tokens"]).all()
    assert not (b1["tokens"] == b3["tokens"]).all()
    # next-token alignment
    assert (b1["tokens"][:, 1:] == b1["labels"][:, :-1]).all()
    assert b1["mask"].dtype == b1["mask"].new_ones(()).dtype


@pytest.mark.parametrize("vocab,seed,stream", [(128, 0, 3), (128256, 5, 0),
                                               (50, 2, 999)])
def test_corpus_tokens_match_jax(vocab, seed, stream):
    np.testing.assert_array_equal(
        TP.SyntheticCorpus(vocab, seed).tokens(300, stream),
        JP.SyntheticCorpus(vocab, seed).tokens(300, stream))


def _stores():
    return JP.StreamingSampleStore(), TP.StreamingSampleStore(device="cpu")


def _same_store(js, ts, where):
    assert_same_arrays(jax_arrays(js.store), to_numpy(ts.store), where)


def test_streaming_store_matches_jax():
    """test_data_serve's ingest / epoch / retire / compact sequence on
    both packages: equal answers and bit-equal store arrays."""
    js, ts = _stores()
    ids = np.arange(100, dtype=np.int32)
    for s in (js, ts):
        s.ingest(ids[:60], ids[:60] * 10)
    _same_store(js, ts, "ingest")
    jsnap, tsnap = js.epoch_view(), ts.epoch_view()
    assert jsnap == tsnap
    for s in (js, ts):           # concurrent ingest does not disturb it
        s.ingest(ids[60:], ids[60:] * 10)
    shard = ts.read_shard(0, 99, tsnap)
    assert shard == js.read_shard(0, 99, jsnap)
    assert [k for k, _ in shard] == list(range(60))
    for s, snap in ((js, jsnap), (ts, tsnap)):
        s.release(snap)
    _same_store(js, ts, "epoch")
    assert ts.live_count() == js.live_count() == 100
    for s in (js, ts):
        s.retire_below(50)
    _same_store(js, ts, "retire")
    assert ts.compact() == js.compact()
    _same_store(js, ts, "compact")
    assert ts.live_count() == js.live_count() == 50


def test_read_shards_fan_out_matches_jax():
    """Several readers' shard ranges in one pass at a held snapshot."""
    js, ts = _stores()
    rng = np.random.default_rng(4)
    ids = rng.choice(5000, 256, replace=False).astype(np.int32)
    for s in (js, ts):
        for i in range(0, 256, 64):     # one plan width: one JAX compile
            s.ingest(ids[i:i + 64], ids[i:i + 64] + 7)
    bounds = [(0, 999), (1000, 2499), (2500, 2500), (4000, 1 << 20)]
    jsnap, tsnap = js.epoch_view(), ts.epoch_view()
    for s in (js, ts):
        s.ingest(np.arange(5000, 5064, dtype=np.int32),
                 np.zeros(64, np.int32))
    got = ts.read_shards(bounds, tsnap)
    assert got == js.read_shards(bounds, jsnap)
    for (lo, hi), page in zip(bounds, got):
        want = np.sort(ids[(ids >= lo) & (ids <= hi)])
        assert page == [(int(k), int(k) + 7) for k in want]
    js.release(jsnap)
    ts.release(tsnap)
    _same_store(js, ts, "fan-out")


@pytest.mark.parametrize("n_shards,shard", [(1, 0), (2, 1)])
def test_epoch_iterator_matches_jax(n_shards, shard):
    jcfg, cfg = _cfgs("lm")
    js, ts = _stores()
    ids = np.arange(20, dtype=np.int32)
    for s in (js, ts):
        s.ingest(ids, ids + 100)
    jb = list(JP.epoch_iterator(js, JP.SyntheticCorpus(jcfg.vocab), jcfg,
                                B=4, S=16, n_shards=n_shards, shard=shard))
    tb = list(TP.epoch_iterator(ts, TP.SyntheticCorpus(cfg.vocab), cfg,
                                B=4, S=16, n_shards=n_shards, shard=shard))
    assert len(tb) == len(jb) == 20 // n_shards // 4
    for a, b in zip(jb, tb):
        _same_batch(a, b)
    assert ts.client.active_snapshots == 0      # the epoch is released
    _same_store(js, ts, "epoch_iterator")


def test_sample_store_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.StreamingSampleStore()
