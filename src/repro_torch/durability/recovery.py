"""The durability sidecar + crash recovery, in PyTorch.

A port of the JAX package's ``repro.durability.recovery``; the directory
layout is the same, so either package recovers what the other wrote.
`Durability` owns one durable directory:

    <dir>/uruv.json     construction config (so recovery of an empty
                        store needs no checkpoint)
    <dir>/wal/          the announce WAL (repro_torch.durability.wal)
    <dir>/ckpt/         checkpoints (repro_torch.checkpoint.manager — full
                        saves + delta chains)

The executors log every committed plan through :meth:`Durability.log_plan`
(append + fsync-bounded group commit) BEFORE its result reaches the
caller; :func:`recover` restores the latest complete checkpoint (walking
a delta chain if that is what is on disk) and replays the WAL tail — each
record re-applied at its recorded ``base_ts`` through ``Uruv.apply``, on
the device the caller names (``cuda`` by default: the replay runs the
store kernels there), so every version timestamp comes out bit-identical
to the uninterrupted run.

Replay rules (deterministic recover-or-reject):

  * ``next_ts <= clock``  — already inside the checkpoint (or a duplicate
    segment replay): skip;
  * ``base_ts == clock``  — apply;
  * anything else         — a gap or a straddling record: the log and the
    checkpoint disagree about history — :class:`WalReplayError`, never a
    silently diverging store.

Read ops (SEARCH / RANGE) replay as NOPs: they wrote nothing, and a NOP
occupies the identical announce slot, so the clock — and therefore every
later version timestamp — advances exactly as it originally did, without
re-running pagination loops.  Nothing on this path reads a wall clock or
a host RNG.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.ref import KEY_MAX, OP_NOP, OP_RANGE, OP_SEARCH
from repro_torch.durability.wal import (
    DEFAULT_SEGMENT_BYTES, Wal, WalRecord, WalReport,
)

CONFIG_FILE = "uruv.json"


class WalReplayError(RuntimeError):
    """The WAL and the checkpoint disagree about history."""


@dataclasses.dataclass(frozen=True)
class RecoveryInfo:
    """What :func:`recover` did — surfaced as ``Uruv.recovery``."""

    wal: WalReport                    # incl. exactly what open() truncated
    checkpoint_step: Optional[int]    # None = recovered from uruv.json only
    replayed_plans: int
    recovered_ts: int


class Durability:
    """WAL + checkpoint manager + config persistence for one client.

    ``group_commit`` bounds the fsync window: 1 (default) fsyncs every
    logged plan before its result is released; k > 1 lets up to k - 1
    confirmed plans await the next fsync (close the window with
    :meth:`sync` — the coalescer's ``flush`` does).  ``device`` is where
    the checkpoint catalogue lives and checkpoints restore (default
    ``cuda``; raises without it).
    """

    def __init__(self, directory, *, group_commit: int = 1,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 keep_checkpoints: int = 2, device=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.wal = Wal.open(self.dir / "wal", segment_bytes=segment_bytes,
                            group_commit=group_commit)
        self.ckpt = CheckpointManager(
            self.dir / "ckpt", keep=keep_checkpoints,
            # synchronous writes: an async thread would race log_plan's
            # fsyncs for the durability ordering the battery asserts
            async_write=False, device=device)

    @property
    def device(self):
        return self.ckpt.device

    # ---------------------------------------------------------------- config
    def write_config(self, config, *, shards: int = 0) -> None:
        """Persist the construction config once (recovery of a store that
        never checkpointed recreates it from this)."""
        path = self.dir / CONFIG_FILE
        if not path.exists():
            path.write_text(json.dumps(
                {"config": dataclasses.asdict(config), "shards": shards}))

    def read_config(self) -> Optional[dict]:
        path = self.dir / CONFIG_FILE
        if not path.exists():
            return None
        return json.loads(path.read_text())

    @property
    def has_history(self) -> bool:
        """Anything already durable here (a fresh client must not silently
        fork it — that is :func:`recover`'s job)."""
        return bool(self.wal.records()) or self.ckpt.latest_step() is not None

    # --------------------------------------------------------------- logging
    def log_plan(self, base_ts: int, codes, keys, values, *,
                 sync: bool = False) -> None:
        """Append one committed plan; durable immediately (``sync``) or
        within the group-commit window."""
        self.wal.append(base_ts, codes, keys, values)
        self.wal.commit(force=sync)

    def sync(self) -> None:
        """Close the group-commit window (one fsync for every pending plan)."""
        self.wal.commit(force=True)

    # ------------------------------------------------------------ checkpoints
    def checkpoint(self, store, step: Optional[int] = None, *,
                   delta: bool = True, compactions: int = 0) -> int:
        """Checkpoint ``store`` and prune fully-covered WAL segments.

        ``delta=True`` writes a delta against the previous checkpoint when
        one exists in this manager (the first save is always full); the
        WAL is synced first so the (checkpoint, WAL-tail) pair never has a
        hole.  ``step`` defaults to the store clock — saving twice at the
        same clock is a no-op (nothing new to make durable).
        """
        self.sync()
        if step is None:
            step = int(store.ts)
        latest = self.ckpt.latest_step()
        if latest is not None and step == latest:
            return step
        if delta and self.ckpt._delta_base is not None:
            self.ckpt.save_store_delta(store, step, compactions=compactions)
        else:
            self.ckpt.save_store(store, step, compactions=compactions)
        self.ckpt.wait()
        self.wal.prune(self.ckpt.store_ts(step))
        return step

    def close(self) -> None:
        self.wal.close()


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

def replay(db, records: List[WalRecord]) -> int:
    """Re-apply the WAL tail onto ``db`` at the recorded timestamps.

    Returns the number of plans applied; raises :class:`WalReplayError`
    on a gap or straddle (module docstring).  The caller must not have a
    durability sidecar attached yet — replay must not re-log the log.
    """
    from repro_torch.api.opbatch import OpBatch

    applied = 0
    for rec in records:
        ts = db.ts
        if rec.next_ts <= ts:
            continue                      # inside the checkpoint / duplicate
        if rec.base_ts != ts:
            if rec.base_ts < ts:
                raise WalReplayError(
                    f"record [{rec.base_ts}, {rec.next_ts}) straddles the "
                    f"recovered clock {ts} — checkpoint and WAL disagree")
            raise WalReplayError(
                f"gap: recovered clock {ts} but the next WAL record "
                f"starts at {rec.base_ts}")
        codes = np.array(rec.codes, np.int32)
        keys = np.array(rec.keys, np.int32)
        values = np.array(rec.values, np.int32)
        reads = (codes == OP_SEARCH) | (codes == OP_RANGE)
        codes[reads] = OP_NOP             # identical clock advance, no
        keys[reads] = KEY_MAX             # pagination re-runs (docstring)
        values[reads] = 0
        db.apply(OpBatch(codes, keys, values))
        applied += 1
        if db.ts != rec.next_ts:
            raise WalReplayError(
                f"replayed record [{rec.base_ts}, {rec.next_ts}) left the "
                f"clock at {db.ts}")
    return applied


def recover(durable_dir, *, device=None, policy=None, group_commit: int = 1,
            segment_bytes: int = DEFAULT_SEGMENT_BYTES):
    """Rebuild the client from a durable directory after a crash.

    Opens the WAL (truncating a torn tail), restores the newest complete
    checkpoint on ``device`` (default ``cuda``) — or recreates the empty
    store from ``uruv.json`` when none exists — replays the WAL tail, and
    re-attaches the sidecar so the recovered client keeps logging into
    the same directory.  The result is bit-identical (values, found
    masks, version timestamps) to the uninterrupted run's confirmed
    prefix; ``db.recovery`` says what happened.
    """
    from repro_torch.api import Uruv, UruvConfig

    dur = Durability(durable_dir, group_commit=group_commit,
                     segment_bytes=segment_bytes, device=device)
    info = dur.read_config()
    if info is None:
        raise FileNotFoundError(
            f"{durable_dir}: no {CONFIG_FILE} — not a durable Uruv directory")
    if info.get("shards"):
        raise NotImplementedError(
            "recover() rebuilds single-device clients; sharded durable "
            "stores are not supported")
    step: Optional[int] = dur.ckpt.latest_step()
    if step is not None:
        store, step = dur.ckpt.restore_store(step)
        db = Uruv.from_store(store, policy=policy)
    else:
        db = Uruv(UruvConfig(**info["config"]), device=dur.device,
                  policy=policy)
    n = replay(db, dur.wal.records())
    db._attach_durability(dur)
    db.recovery = RecoveryInfo(
        wal=dur.wal.report, checkpoint_step=step,
        replayed_plans=n, recovered_ts=db.ts,
    )
    return db
