"""The rank side of tests/test_torch_dist.py: the scenarios, and the
processes that run them one shard a process over a gloo group.

Each scenario is written once, against the client or the sharded module
it is given, so the test process runs the very same calls on the JAX
package's sharded code (under ``_torch_port.emulate_jax_sharding``) and
on the port's stacked store, and each rank runs them on its block.  This
module imports no ``jax``: a spawned rank imports it (and ``repro_torch``)
and nothing of the JAX package.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N = 4
KEY_HI = 1000
CFG = dict(leaf_cap=16, max_leaves=16, max_versions=1 << 10, tracker_cap=8,
           max_chain=16, index_fanout=4)
POLICY = dict(min_dead_leaves=4)
INIT_TIMEOUT_S = 60          # init_process_group's timeout
OP_INSERT, OP_DELETE, OP_SEARCH = 0, 1, 2        # both packages' codes
RESULT_FIELDS = ("values", "found", "timestamps", "range_index",
                 "range_resume")
PAGE_FIELDS = ("keys", "values", "count", "truncated", "resume_k1")


def host(x):
    """A tensor, JAX array or number as numpy."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def crud(rng, n, lo=0, hi=KEY_HI):
    r = rng.random(n)
    codes = np.where(r < 0.55, OP_INSERT,
                     np.where(r < 0.7, OP_DELETE, OP_SEARCH)).astype(np.int32)
    keys = rng.integers(lo, hi, n).astype(np.int32)
    vals = rng.integers(1, 10_000, n).astype(np.int32)
    return codes, keys, vals


def shard0_inserts():
    """16 inserts whose keys all fall on shard 0: each source slice owes
    shard 0 all its ops, past the routing budget (the replicated
    fallback)."""
    return (np.full(16, OP_INSERT, np.int32),
            np.arange(16, dtype=np.int32) * 7,
            np.arange(1, 17, dtype=np.int32))


# ------------------------------------------------------------- scenarios
def client_script(db, api, seed: int = 42, n_plans: int = 6) -> list:
    """Plans of 16 CRUD, 4 RANGE and 16 CRUD ops (both CRUD segments take
    the routed pass; one width keeps the JAX side's compiles few) with a
    snapshot held from plan 3, the forced
    replicated fallback, reads at the held snapshot, its release,
    ``maintain``, ``reindex`` and ``compact``: everything a client
    returns, in order."""
    rng = np.random.default_rng(seed)
    trace, held = [], None

    def result(r):
        return [host(getattr(r, f)) for f in RESULT_FIELDS] + [r.pages()]

    for p in range(n_plans):
        if p == 3:
            held = db.acquire_snapshot()
            trace.append(held)
        a, b = crud(rng, 16), crud(rng, 16)
        lo = rng.integers(0, KEY_HI, 4).astype(np.int32)
        hi = (lo + rng.integers(-5, 300, 4)).astype(np.int32)
        trace.append(result(db.apply(api.OpBatch.concat(
            api.OpBatch(*a), api.OpBatch.ranges(lo, hi), api.OpBatch(*b)))))
    trace.append(result(db.apply(api.OpBatch(*shard0_inserts()))))
    k1 = np.array([0, 300, 600, 999], np.int32)
    k2 = np.array([350, 650, 998, 999], np.int32)
    trace.append(db.range_all(k1, k2, held))
    page = db.range_page(k1, k2, held)
    trace.append([host(getattr(page, f)) for f in PAGE_FIELDS])
    probe = rng.integers(0, KEY_HI, 16).astype(np.int32)
    trace += [host(db.lookup(probe, held)), host(db.lookup(probe))]
    db.release_snapshot(held)
    trace.append(int(db.active_snapshots))
    trace.append(tuple(int(x) for x in db.maintain()))
    db.reindex()
    trace.append(int(db.compact()))
    trace += [int(db.ts), dict(db.stats), db.live_items(),
              int(db.capacity.max_leaves)]
    return trace


def core_script(SH, cfg, mesh, store, arr=lambda x: x):
    """The core passes of a sharded module ``SH`` (JAX's or the port's)
    from ``store``: ``make_apply`` and ``make_routed_apply`` (route
    factor 3) on 6 plans and the forced fallback, sequenced by
    ``sharded_apply_batch``; ``make_range_apply`` paginated at budgets
    that truncate at the frontier; ``make_ops``' update, lookup and
    ``range_q``.  ``arr`` makes a pass's array arguments (``jnp.asarray``
    for JAX).  Returns ``(trace, store)``."""
    rng = np.random.default_rng(7)
    trace = []
    app = SH.make_apply(cfg, mesh)
    rtd = SH.make_routed_apply(cfg, mesh, route_factor=3)
    for plan in [crud(rng, 16) for _ in range(6)] + [shard0_inserts()]:
        for f in (app, rtd):
            _, res, ok = f(store, *(arr(x) for x in plan))
            trace += [host(res), bool(ok)]
        stats = {}
        store, res = SH.sharded_apply_batch(store, *plan, apply_fn=app,
                                            routed_fn=rtd, stats=stats)
        trace += [host(res), stats]

    rr = SH.make_range_apply(cfg, mesh, max_results=8, scan_leaves=1,
                             max_rounds=1)
    k1 = np.array([0, 100, 240, 260, 490, 700, 999, 5], np.int32)
    k2 = np.array([999, 160, 270, 255, 760, 990, 999, 30], np.int32)
    snap = np.full(8, SH.global_ts(store), np.int32)
    lo = k1.copy()
    for _ in range(40):
        out = [host(x) for x in rr(store, arr(lo), arr(k2), arr(snap))]
        trace.append(out)
        trunc, resume = out[3], out[4]
        if not trunc.any():
            break
        lo = np.where(trunc, resume, np.int32(2**31 - 1)).astype(np.int32)

    upd, lkp, rq = SH.make_ops(cfg, mesh)
    for _ in range(3):
        keys = rng.integers(0, KEY_HI, 16).astype(np.int32)
        vals = rng.integers(1, 500, 16).astype(np.int32)
        vals[rng.random(16) < 0.2] = -(2**31) + 1         # TOMBSTONE
        keys[-1] = 2**31 - 1                              # a pad (NOP)
        store, res, ok = upd(store, arr(keys), arr(vals))
        trace += [host(res), bool(ok)]
    now = SH.global_ts(store)
    probe = np.concatenate([rng.integers(0, KEY_HI, 15),
                            [2**31 - 1]]).astype(np.int32)
    for s in (now, now - 40):
        trace.append(host(lkp(store, arr(probe), arr(np.int32(s)))))
    for a, b in ((0, 999), (240, 260), (10, 5)):
        out = rq(store, a, b, now, max_scan_leaves=2, max_results=8)
        trace += [[host(x) for x in out], SH.merge_range_results(*out[:3])]
    trace.append(SH.global_ts(store))
    return trace, store


def capacity_script(db, api, seed: int = 5) -> list:
    """Plans of 16 inserts, three quarters of their keys on shard 0, into
    a fixed-footprint client until it raises ``CapacityError``: the plan
    that raised and the error's ``oflow``, ``occupancy``,
    ``frozen_fraction``, ``n_vers`` and ``max_versions``."""
    rng = np.random.default_rng(seed)
    for p in range(64):
        keys = np.where(rng.random(16) < 0.75,
                        rng.integers(0, KEY_HI // N, 16),
                        rng.integers(0, KEY_HI, 16)).astype(np.int32)
        vals = rng.integers(1, 10_000, 16).astype(np.int32)
        try:
            db.apply(api.OpBatch(np.full(16, OP_INSERT, np.int32), keys,
                                 vals))
        except api.CapacityError as e:
            return [p, e.oflow, e.occupancy, e.frozen_fraction, e.n_vers,
                    e.max_versions]
    return [None]


def routed_script(SH, cfg, mesh, store):
    """One routed plan of 16 ops on an empty store, then a lookup of its
    keys: ``(trace, store)``."""
    plan = crud(np.random.default_rng(11), 16)
    store, res, ok = SH.make_routed_apply(cfg, mesh)(store, *plan)
    _, lookup, _ = SH.make_ops(cfg, mesh)
    now = SH.global_ts(store)
    return [host(res), bool(ok), host(lookup(store, plan[1], now)),
            now], store


def psum_inputs() -> np.ndarray:
    """Each rank's gradient for ``compressed_psum``: [N, 64, 8] fp32."""
    return np.random.default_rng(3).standard_normal(
        (N, 64, 8)).astype(np.float32)


def tree_inputs() -> dict:
    g = np.random.default_rng(4)
    return {"b": torch.from_numpy(g.standard_normal(8).astype(np.float32)),
            "w": torch.from_numpy(g.integers(0, 99, (8, 3)).astype(
                np.int32))}


def more_plans(seed: int):
    rng = np.random.default_rng(seed)
    return [crud(rng, 16) for _ in range(3)]


# ------------------------------------------------------------ the ranks
def _client(rank, group, tmp):
    import repro_torch.api as T
    from repro_torch.core import store as TS
    from repro_torch.launch.mesh import make_host_mesh

    cfg = T.ShardedConfig(base=T.UruvConfig(**dict(CFG, max_leaves=4)),
                          key_hi=KEY_HI)
    db = T.Uruv.sharded(cfg, make_host_mesh(N, device="cpu", group=group),
                        policy=T.LifecyclePolicy(**POLICY))
    trace = client_script(db, T)
    return dict(trace=trace, block=TS.to_numpy(db.store))


def _capacity(rank, group, tmp):
    import repro_torch.api as T
    from repro_torch.core import store as TS
    from repro_torch.launch.mesh import make_host_mesh

    cfg = T.ShardedConfig(base=T.UruvConfig(**CFG), key_hi=KEY_HI)
    db = T.Uruv.sharded(cfg, make_host_mesh(N, device="cpu", group=group),
                        policy=T.FIXED_FOOTPRINT)
    error = capacity_script(db, T)
    return dict(error=error, block=TS.to_numpy(db.store))


def _core(rank, group, tmp):
    from repro_torch.core import sharded as TSH
    from repro_torch.core import store as TS
    from repro_torch.core.store import UruvConfig
    from repro_torch.launch.mesh import make_host_mesh

    from repro_torch.distributed.fault import GroupPlacement

    cfg = TSH.ShardedConfig(base=UruvConfig(**CFG), key_hi=KEY_HI)
    mesh = make_host_mesh(N, device="cpu", group=group)
    trace, store = core_script(TSH, cfg, mesh, TSH.create(cfg, mesh))
    refused = []
    for call in (lambda: make_host_mesh(N - 1, device="cpu", group=group),
                 lambda: make_host_mesh(N, group=group),
                 lambda: GroupPlacement(group)):
        try:
            call()
            refused.append(None)
        except (ValueError, RuntimeError) as e:
            refused.append(type(e).__name__)
    return dict(trace=trace, block=TS.to_numpy(store), refused=refused,
                cuda=torch.cuda.is_available())


def _elastic(rank, group, tmp):
    import repro_torch.api as T
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import store as TS
    from repro_torch.distributed.fault import GroupPlacement, reshard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.compression import compressed_psum

    out = {"psum": compressed_psum(
        torch.from_numpy(psum_inputs()[rank]), group).numpy()}
    place = GroupPlacement(group, "cpu")
    tree = tree_inputs()
    mgr = CheckpointManager(os.path.join(tmp, "tree"), async_write=False,
                            device="cpu")
    blocks, _ = mgr.restore(tree, shardings=place)
    out["tree_blocks"] = {k: v.numpy() for k, v in blocks.items()}
    whole = reshard(blocks, "cpu", current=place)
    out["tree_whole"] = {k: v.numpy() for k, v in whole.items()}

    src = CheckpointManager(os.path.join(tmp, "stacked"), async_write=False,
                            device="cpu")
    store, step = src.restore_store(shardings=place)
    out["restored"] = (step, TS.to_numpy(store))
    cfg = T.ShardedConfig(base=store.cfg, key_hi=KEY_HI)
    db = T.Uruv.sharded(cfg, make_host_mesh(N, device="cpu", group=group),
                        store=store)
    dst = CheckpointManager(os.path.join(tmp, "from_group"),
                            device="cpu")
    plans = more_plans(5)
    for p in plans[:2]:
        db.apply(T.OpBatch(*p))
    dst.save_store(db.store, 10, group=group)
    db.apply(T.OpBatch(*plans[2]))
    out["delta"] = dst.save_store_delta(db.store, 11, group=group)
    out["latest"] = dst.latest_step()
    out["block"] = TS.to_numpy(db.store)
    return out


def _card(rank, group, tmp):
    from repro_torch.core import sharded as TSH
    from repro_torch.core import store as TS
    from repro_torch.core.store import UruvConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    cfg = TSH.ShardedConfig(base=UruvConfig(**CFG), key_hi=KEY_HI)
    mesh = make_host_mesh(dist.get_world_size(group), group=group)
    _build.launch_counts.clear()
    trace, store = routed_script(TSH, cfg, mesh, TSH.create(cfg, mesh))
    return dict(trace=trace, block=TS.to_numpy(store),
                launches=dict(_build.launch_counts))


SCENARIOS = {"client": _client, "core": _core, "elastic": _elastic,
             "card": _card, "capacity": _capacity}


def _rank_main(name: str, rank: int, n: int, tmp: str,
               backend: str) -> None:
    torch.set_num_threads(1)
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rdv"),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        try:
            out = SCENARIOS[name](rank, dist.group.WORLD, tmp)
            out["modules"] = sorted({m.split(".")[0] for m in sys.modules})
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """Scenario ``name`` on ``n`` spawned ranks of a ``backend`` group (a
    ``file://`` rendezvous under ``tmp``), started at once.  :meth:`results` waits
    for them: each rank's outputs in rank order, or an error, after
    every rank still alive is killed, when a rank failed or the ranks
    outlived ``limit_s``.  Leaving the ``with`` block kills any rank
    left, so none outlives its test."""

    def __init__(self, name: str, tmp, limit_s: float = 150.0, n: int = N,
                 backend: str = "gloo"):
        self.name, self.tmp, self.limit_s = name, str(tmp), limit_s
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(name, r, n, self.tmp, backend))
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + limit_s

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._kill()

    def _kill(self) -> list:
        late = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        return late

    def results(self) -> list:
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        late = self._kill()
        errs = []
        for r in range(len(self.procs)):
            path = os.path.join(self.tmp, f"err_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"rank {r}:\n" + f.read())
        codes = [p.exitcode for p in self.procs]
        if late or errs or any(c != 0 for c in codes):
            raise RuntimeError(
                f"scenario {self.name}: ranks {late} outlived "
                f"{self.limit_s} s, exit codes {codes}\n" + "\n".join(errs))
        outs = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.tmp, f"out_{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
