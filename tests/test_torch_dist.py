"""The sharded store one shard a process: 4 gloo ranks on the CPU against
the JAX package's sharded code and the port's stacked store.

Each test spawns 4 ranks (``_dist_ranks.Ranks``: ``spawn`` start method,
a ``file://`` rendezvous under ``tmp_path``, ``init_process_group``
timeout 60 s, a join limit that kills every rank and fails the test).
Each rank holds its shard as a [1] block on ``device="cpu"`` and runs a
scenario of ``_dist_ranks``; meanwhile this process runs the same
scenario on the JAX package's sharded code (``_torch_port.
emulate_jax_sharding``: ``shard_map`` through ``jax.vmap``) and on the
port's stacked store of 4 shards.  Every rank's answers, timestamps,
range pages, resume frontiers, counters and clock must equal both, its
block must equal shard ``rank`` of the stacked arrays, and the ranks
import neither ``jax`` nor the JAX package.  Pools are
``test_torch_sharded.py``'s small ones (``leaf_cap=16``, ``max_leaves``
16, or 4 to make the client grow).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro import api as J
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core import sharded as JSH
from repro.optim.compression import compressed_psum as jcompressed_psum

import repro_torch.api as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import sharded as TSH
from repro_torch.core import store as TS
from repro_torch.launch.mesh import make_host_mesh

import _dist_ranks as R
from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    FakeMesh, assert_same_arrays, emulate_jax_sharding, fresh_jax_caches,
    jax_arrays, jax_stacked_store,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

N = R.N


@pytest.fixture(autouse=True)
def jax_sharding(monkeypatch):
    emulate_jax_sharding(monkeypatch)


def _configs(**over):
    cfg = dict(R.CFG, **over)
    return (JSH.ShardedConfig(base=J.UruvConfig(**cfg), key_hi=R.KEY_HI),
            TSH.ShardedConfig(base=T.UruvConfig(**cfg), key_hi=R.KEY_HI))


def _same(a, b, where):
    """Equal nested traces: lists, tuples, dicts, arrays, numbers."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    else:
        assert a == b, (where, a, b)


def _shard(arrays: dict, r: int) -> dict:
    return {k: v[r:r + 1] for k, v in arrays.items()}


def _check_ranks(outs, trace, stacked, where):
    """Every rank: the stacked store's trace, its block = shard r, and
    nothing of JAX imported."""
    for r, o in enumerate(outs):
        _same(o["trace"], trace, f"{where}: rank {r}")
        assert_same_arrays(o["block"], _shard(stacked, r),
                           f"{where}: rank {r}'s block")
        assert not {"jax", "jaxlib", "repro"} & set(o["modules"]), r


def test_group_client_matches_jax_and_stacked(tmp_path):
    """``Uruv.sharded`` over a group mesh: routed plans with ranges, a held
    snapshot, the forced replicated fallback, capacity rejections relieved
    by growth, the lifecycle's maintain, ``reindex``, ``compact``."""
    with R.Ranks("client", tmp_path) as ranks:
        jcfg, tcfg = _configs(max_leaves=4)
        jdb = J.Uruv.sharded(jcfg, FakeMesh(N),
                             store=jax_stacked_store(jcfg.base, N),
                             policy=J.LifecyclePolicy(**R.POLICY))
        tdb = T.Uruv.sharded(tcfg, make_host_mesh(N, device="cpu"),
                             policy=T.LifecyclePolicy(**R.POLICY))
        jtrace = R.client_script(jdb, J)
        ttrace = R.client_script(tdb, T)
        outs = ranks.results()
    _same(jtrace, ttrace, "JAX against the stacked store")
    stacked = TS.to_numpy(tdb.store)
    assert_same_arrays(jax_arrays(jdb.store), stacked, "JAX's stacked store")
    _check_ranks(outs, ttrace, stacked, "client")
    stats = ttrace[-3]
    assert stats["grows"] > 0 and stats["slow_path_rounds"] > 0
    assert stats["maintain_passes"] > 0 and stats["reindexes"] == 1
    assert ttrace[-1] > 4                           # the pools grew


def test_group_capacity_error_reports_the_whole_store(tmp_path):
    """A fixed-footprint group client driven to capacity: every rank's
    ``CapacityError`` carries the stacked client's ``oflow``,
    ``occupancy``, ``frozen_fraction`` and ``n_vers`` (read across the
    group), not its own shard's; its block is shard ``rank`` of the
    stacked store's when it raised."""
    with R.Ranks("capacity", tmp_path) as ranks:
        _, tcfg = _configs()
        tdb = T.Uruv.sharded(tcfg, make_host_mesh(N, device="cpu"),
                             policy=T.FIXED_FOOTPRINT)
        want = R.capacity_script(tdb, T)
        outs = ranks.results()
    assert want[0] is not None, "the stacked client never filled"
    assert want[1] != 0 and 0 < want[2] <= 1 and want[4] > 0, want
    stacked = TS.to_numpy(tdb.store)
    for r, o in enumerate(outs):
        assert o["error"] == want, (r, o["error"], want)
        assert_same_arrays(o["block"], _shard(stacked, r), f"rank {r}")
        assert not {"jax", "jaxlib", "repro"} & set(o["modules"]), r


def test_group_core_passes_match_jax_and_stacked(tmp_path):
    """``make_apply``, ``make_routed_apply`` (its forced fallback too),
    ``sharded_apply_batch``, ``make_range_apply`` truncated at the frontier
    and paginated, ``make_ops``; and the group mesh's refusals."""
    with R.Ranks("core", tmp_path) as ranks:
        jcfg, tcfg = _configs()
        jtrace, jstore = R.core_script(JSH, jcfg, FakeMesh(N),
                                       jax_stacked_store(jcfg.base, N),
                                       jnp.asarray)
        ttrace, tstore = R.core_script(
            TSH, tcfg, make_host_mesh(N, device="cpu"),
            TSH.create(tcfg, make_host_mesh(N, device="cpu")))
        outs = ranks.results()
    _same(jtrace, ttrace, "JAX against the stacked store")
    stacked = TS.to_numpy(tstore)
    assert_same_arrays(jax_arrays(jstore), stacked, "JAX's stacked store")
    _check_ranks(outs, ttrace, stacked, "core")
    oks = [x for x in ttrace if isinstance(x, bool)]
    assert True in oks and False in oks             # the fallback ran
    rounds = [x for x in ttrace if isinstance(x, list) and len(x) == 5]
    assert len(rounds) > 1 and rounds[0][3].any()   # truncated, resumed
    for o in outs:
        refused = "RuntimeError" if not o["cuda"] else None
        assert o["refused"] == ["ValueError", refused, refused]


def test_group_compressed_psum_and_elastic_checkpoint(tmp_path):
    """``compressed_psum`` over 4 ranks against JAX's under ``jax.vmap``;
    a tree and a stacked store checkpoint restored onto the ranks
    (``shardings=GroupPlacement``), ``reshard`` back to one device, and
    full and delta saves from the group equal to the stacked store's."""
    _, tcfg = _configs()
    tdb = T.Uruv.sharded(tcfg, make_host_mesh(N, device="cpu"))
    for p in R.more_plans(9):
        tdb.apply(T.OpBatch(*p))
    CheckpointManager(tmp_path / "stacked", async_write=False,
                      device="cpu").save_store(tdb.store, 3)
    CheckpointManager(tmp_path / "tree", async_write=False,
                      device="cpu").save(R.tree_inputs(), 5)
    at_3 = TS.to_numpy(tdb.store)
    with R.Ranks("elastic", tmp_path) as ranks:
        g = R.psum_inputs()
        want = np.asarray(jax.vmap(lambda x: jcompressed_psum(x, "data"),
                                   axis_name="data")(jnp.asarray(g)))
        mgr = CheckpointManager(tmp_path / "from_stacked", device="cpu")
        plans = R.more_plans(5)
        for p in plans[:2]:
            tdb.apply(T.OpBatch(*p))
        mgr.save_store(tdb.store, 10)
        tdb.apply(T.OpBatch(*plans[2]))
        counts = mgr.save_store_delta(tdb.store, 11)
        mgr.wait()
        outs = ranks.results()
    final = TS.to_numpy(tdb.store)
    tree = {k: v.numpy() for k, v in R.tree_inputs().items()}
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["psum"], want[r])   # bit-equal
        for k, v in tree.items():
            np.testing.assert_array_equal(o["tree_blocks"][k],
                                          v[2 * r:2 * r + 2])
            np.testing.assert_array_equal(o["tree_whole"][k], v)
        assert o["restored"][0] == 3
        assert_same_arrays(o["restored"][1], _shard(at_3, r), f"rank {r}")
        assert o["delta"] == counts and o["latest"] == 11
        assert_same_arrays(o["block"], _shard(final, r), f"rank {r}")
    group_dir, stacked_dir = tmp_path / "from_group", tmp_path / "from_stacked"
    for step in (10, 11):
        man = [json.loads((d / f"step_{step:08d}" / "manifest.json")
                          .read_text()) for d in (group_dir, stacked_dir)]
        assert man[0] == man[1] and man[0]["uruv_shards"] == N
        got = [TS.to_numpy(CheckpointManager(d, device="cpu")
                           .restore_store(step)[0])
               for d in (group_dir, stacked_dir)]
        assert_same_arrays(got[0], got[1], f"step {step}")
    jstore, _ = JCheckpointManager(str(group_dir)).restore_store(11)
    assert_same_arrays(jax_arrays(jstore), final, "JAX reads the group's")
