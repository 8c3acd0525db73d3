"""Store checkpoints — full saves and delta chains — in the JAX package's
on-disk format.

A port of the store path of ``repro.checkpoint.manager`` (DESIGN.md
Sec 3 and 14):

  * SAVE    — write each store array to a temporary step directory, then
    rename it into place (atomic publish) and INSERT ``step -> 1`` into
    the step catalogue, itself a small port ``Uruv`` on the manager's
    device.
  * RESTORE — read the newest *complete* step (its manifest exists and
    every delta link resolves) and rebuild the store on the manager's
    device; the manifest's recorded ``UruvConfig`` carries the LIVE
    capacities, so a grown store restores with its grown shapes.
  * GC      — superseded steps are deleted from the catalogue and their
    directories removed; a delta's base chain always outlives it.

``save_store_delta`` writes only what changed since the previous save in
this manager: per array ``same`` (nothing written), ``rows`` (changed
rows by index; the version pool takes the allocator TAIL through
``repro_torch.core.lifecycle.pool_watermarks`` / ``version_tail_start``
instead of a diff) or ``full``.

On-disk names.  A step directory holds one ``.npy`` per store array (a
delta's ``rows`` entries are ``.npz`` with ``idx`` and ``rows``) plus
``manifest.json``.  Arrays are named by the JAX store's tree paths, in
its flattening order — ``.leaf_keys``, ``.index/.node_keys/0``,
``.index/.stat_delta_passes``, ``.ts`` — stored as files with ``/``
spelled ``__`` (``.index__.node_keys__0.npy``).  :func:`_disk_name` maps
the port's ``store.to_numpy`` keys (``leaf_keys``, ``index.node_keys.0``)
onto them, so either package restores a directory the other wrote.

The generic pytree ``save`` / ``restore`` of the JAX manager (training
state) is carried only as far as the store path uses it: :meth:`save`
takes a flat list of named host arrays.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import KEY_DOMAIN_HI, Uruv, UruvConfig
from repro_torch.core.lifecycle import (
    PoolWatermarks, pool_watermarks, version_tail_start,
)
from repro_torch.core.store import from_numpy, resolve_device, to_numpy
from repro_torch.distributed.fault import crash_point


def _disk_name(name: str) -> str:
    """Port array key -> the JAX tree-path name: ``leaf_keys`` ->
    ``.leaf_keys``, ``index.ord_node`` -> ``.index/.ord_node``,
    ``index.node_keys.0`` -> ``.index/.node_keys/0``."""
    parts = name.split(".")
    return "/".join(["." + p for p in parts[:2]] + parts[2:])


def _port_name(name: str) -> str:
    """The inverse of :func:`_disk_name`."""
    return ".".join(p.lstrip(".") for p in name.split("/"))


def _flatten(store) -> List[Tuple[str, np.ndarray]]:
    """The store's arrays as ``(disk name, host array)`` in the JAX
    flattening order (``to_numpy`` keeps the dataclass field order, which
    is the JAX store's)."""
    return [(_disk_name(k), v) for k, v in to_numpy(store).items()]


# version-pool arrays whose slots below the allocator watermark are
# immutable between compactions (lifecycle.version_tail_start)
_VER_TAIL_ARRAYS = (".ver_value", ".ver_ts", ".ver_next")

# row-delta sparsity cutoff: past this changed-row fraction a full array
# write is smaller than idx + rows
_DELTA_FULL_FRAC = 0.5


class CheckpointManager:
    """Checkpoints of a port store in ``directory``, with the step
    catalogue on ``device`` (default ``cuda``; raises without it)."""

    def __init__(self, directory, keep: int = 3, async_write: bool = True,
                 *, device=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self.device = resolve_device(device)
        self.index = Uruv(
            UruvConfig(leaf_cap=16, max_leaves=512, max_versions=1 << 14),
            device=self.device)
        self._pending: Optional[threading.Thread] = None
        # host copy + watermarks of the last save_store/save_store_delta —
        # the diff base for the next delta (process-local by design: a
        # fresh manager starts a fresh chain with a full save)
        self._delta_base: Optional[Tuple[int, Dict[str, np.ndarray]]] = None
        self._delta_marks: Optional[PoolWatermarks] = None
        self._load_existing()

    # ------------------------------------------------------------------ save
    def save(self, leaves: List[Tuple[str, np.ndarray]], step: int,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Write ``leaves`` (named host arrays, in order) as step
        ``step``, every array in full."""
        self.wait()                              # one in-flight write

        def write():
            manifest = {"step": step, "leaves": [], **(extra or {})}
            with self._publish(step) as tmp:
                for name, leaf in leaves:
                    fn = name.replace("/", "__") + ".npy"
                    np.save(tmp / fn, leaf)
                    manifest["leaves"].append(
                        {"name": name, "file": fn, "mode": "full",
                         "shape": list(np.shape(leaf)),
                         "dtype": str(np.asarray(leaf).dtype)})
                (tmp / "manifest.json").write_text(json.dumps(manifest))

        self._run_write(write)

    def _publish(self, step: int):
        """tmp-write -> atomic-rename -> catalogue insert -> GC, with the
        battery's crash points on either side of the rename."""
        mgr = self

        class _Publish:
            def __enter__(self):
                self.man_dir = mgr.dir / f"step_{step:08d}"
                self.tmp = mgr.dir / f".tmp_step_{step:08d}"
                if self.tmp.exists():
                    shutil.rmtree(self.tmp)
                self.tmp.mkdir()
                return self.tmp

            def __exit__(self, exc_type, exc, tb):
                if exc_type is not None:
                    return False
                crash_point("ckpt.tmp_written")
                if self.man_dir.exists():
                    shutil.rmtree(self.man_dir)
                self.tmp.rename(self.man_dir)     # atomic publish
                crash_point("ckpt.renamed")
                # catalogue insert: key = step, value = 1 (manifest id)
                mgr.index.insert([step], [1])
                mgr._gc()
                return False

        return _Publish()

    def _run_write(self, write) -> None:
        if self.async_write:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        self.wait()
        with self.index.snapshot() as snap:
            items = self.index.range(0, KEY_DOMAIN_HI, snap)
        steps = [k for k, v in items if v == 1]
        return max(steps) if steps else None

    def _manifest(self, step: int) -> Dict[str, Any]:
        man_path = self.dir / f"step_{step:08d}" / "manifest.json"
        if not man_path.exists():
            raise FileNotFoundError(f"no complete checkpoint at step {step}")
        return json.loads(man_path.read_text())

    def _host_leaves(self, step: int) -> Dict[str, np.ndarray]:
        """Materialize the saved host arrays at ``step``, replaying the
        delta chain back to its base full save."""
        manifest = self._manifest(step)
        man_dir = self.dir / f"step_{step:08d}"
        if manifest.get("kind") != "delta":
            return {rec["name"]: np.load(man_dir / rec["file"])
                    for rec in manifest["leaves"]}
        out = self._host_leaves(manifest["base_step"])
        for rec in manifest["leaves"]:
            name, mode = rec["name"], rec["mode"]
            if mode == "same":
                continue
            if mode == "full":
                out[name] = np.load(man_dir / rec["file"])
            elif mode == "rows":
                with np.load(man_dir / rec["file"]) as z:
                    idx, rows = z["idx"], z["rows"]
                arr = out[name].copy()
                arr[idx] = rows
                out[name] = arr
            else:
                raise ValueError(f"unknown delta mode {mode!r} for {name}")
            if list(out[name].shape) != rec["shape"]:
                raise ValueError(
                    f"delta chain shape mismatch for {name}: "
                    f"{list(out[name].shape)} != {rec['shape']}")
        return out

    # ------------------------------------------------- store-aware round-trip
    @staticmethod
    def _store_extra(store) -> Dict[str, Any]:
        return {"uruv_config": dataclasses.asdict(store.cfg),
                "uruv_shards": 0, "uruv_ts": int(store.ts)}

    def save_store(self, store, step: int, *, compactions: int = 0) -> None:
        """Checkpoint a port store in full, its LIVE capacities recorded
        in the manifest; (re)bases the delta chain on this save."""
        flat = _flatten(store)
        self._delta_base = (step, dict(flat))
        self._delta_marks = pool_watermarks(store, compactions=compactions)
        self.save(flat, step, extra=self._store_extra(store))

    def save_store_delta(self, store, step: int, *,
                         compactions: int = 0) -> Dict[str, int]:
        """Checkpoint only what changed since the last ``save_store`` /
        ``save_store_delta`` in this manager.

        Per array: ``same`` (bit-identical — nothing written), ``rows``
        (changed rows by index; the version pool writes its allocator
        tail, from the ``version_tail_start`` watermark, without a diff),
        or ``full`` (0-d scalars that changed, shape changes after
        ``grow``, diffs too dense for a sparse win).  Returns per-mode
        array counts.  Requires a prior :meth:`save_store` here."""
        if self._delta_base is None:
            raise ValueError(
                "save_store_delta requires a prior save_store in this "
                "manager (the delta chain needs a base full save)")
        self.wait()
        base_step, base = self._delta_base
        flat = _flatten(store)
        host = dict(flat)
        tail_start = version_tail_start(
            self._delta_marks, store, compactions=compactions) \
            if self._delta_marks is not None else None
        n_vers = int(host[".n_vers"])

        entries: List[Tuple[Dict[str, Any], Optional[Any]]] = []
        counts = {"same": 0, "rows": 0, "full": 0}
        for name, arr in flat:
            rec = {"name": name, "shape": list(arr.shape),
                   "dtype": str(arr.dtype)}
            old = base.get(name)
            mode, payload = "full", arr
            if old is not None and old.shape == arr.shape:
                if arr.ndim and name in _VER_TAIL_ARRAYS \
                        and tail_start is not None:
                    # append-only pool: the delta IS the allocator tail
                    idx = np.arange(tail_start, n_vers, dtype=np.int64)
                    mode, payload = "rows", (idx, arr[tail_start:n_vers])
                elif arr.ndim == 0:
                    mode = "same" if old == arr else "full"
                    payload = None if mode == "same" else arr
                else:
                    diff = old != arr
                    changed = np.flatnonzero(
                        diff.reshape(arr.shape[0], -1).any(axis=1))
                    if changed.size == 0:
                        mode, payload = "same", None
                    elif changed.size <= _DELTA_FULL_FRAC * arr.shape[0]:
                        mode, payload = "rows", (changed, arr[changed])
            rec["mode"] = mode
            counts[mode] += 1
            entries.append((rec, payload))

        self._delta_base = (step, host)
        self._delta_marks = pool_watermarks(store, compactions=compactions)
        manifest = {"step": step, "kind": "delta", "base_step": base_step,
                    "leaves": [], **self._store_extra(store)}

        def write():
            with self._publish(step) as tmp:
                for rec, payload in entries:
                    if rec["mode"] == "full":
                        fn = rec["name"].replace("/", "__") + ".npy"
                        np.save(tmp / fn, payload)
                        rec["file"] = fn
                    elif rec["mode"] == "rows":
                        fn = rec["name"].replace("/", "__") + ".npz"
                        idx, rows = payload
                        np.savez(tmp / fn, idx=idx, rows=rows)
                        rec["file"] = fn
                    manifest["leaves"].append(rec)
                (tmp / "manifest.json").write_text(json.dumps(manifest))

        self._run_write(write)
        return counts

    def restore_store(self, step: Optional[int] = None):
        """Rebuild the store saved by :meth:`save_store` (or a
        :meth:`save_store_delta` chain) on the manager's device, at the
        manifest's recorded ``UruvConfig``.  Returns ``(store, step)``."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no complete checkpoint found")
        manifest = self._manifest(step)
        if "uruv_config" not in manifest:
            raise ValueError(
                f"checkpoint step {step} was not written by save_store")
        if manifest.get("uruv_shards"):
            raise NotImplementedError(
                "the port restores single-device stores; this checkpoint "
                "holds a sharded store")
        arrays = {_port_name(k): v
                  for k, v in self._host_leaves(step).items()}
        cfg = UruvConfig(**manifest["uruv_config"])
        return from_numpy(arrays, cfg, self.device), step

    def store_ts(self, step: Optional[int] = None) -> int:
        """The clock recorded at a ``save_store*`` step (manifest field —
        no array loads); recovery prunes WAL segments below it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no complete checkpoint found")
        return int(self._manifest(step)["uruv_ts"])

    # -------------------------------------------------------------------- gc
    def _chain(self, step: int) -> List[int]:
        """``step`` plus every base it transitively needs (innermost last);
        raises FileNotFoundError when a link is missing."""
        out = [step]
        manifest = self._manifest(step)
        while manifest.get("kind") == "delta":
            step = int(manifest["base_step"])
            out.append(step)
            manifest = self._manifest(step)
        return out

    def _gc(self) -> None:
        with self.index.snapshot() as snap:
            items = self.index.range(0, KEY_DOMAIN_HI, snap)
        steps = sorted(k for k, v in items if v == 1)
        kept = steps[-self.keep:] if self.keep else steps
        # a delta's base chain must outlive it — never drop a step a kept
        # delta still restores through
        required = set(kept)
        for s in kept:
            required.update(self._chain(s))
        drop = [s for s in steps if s not in required]
        if drop:
            self.index.delete(np.array(drop, np.int32))
            self.index.compact()
            for s in drop:
                d = self.dir / f"step_{s:08d}"
                if d.exists():
                    shutil.rmtree(d)

    def _load_existing(self) -> None:
        # a crashed writer leaves .tmp_step_* behind; left in place they
        # leak forever (nothing ever removes a tmp dir whose step is never
        # saved again) — scrub them before anything else
        for tmp in self.dir.glob(".tmp_step_*"):
            shutil.rmtree(tmp)
        steps = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():
                steps.append(int(d.name.split("_")[1]))
        complete = []
        for s in sorted(steps):
            try:
                self._chain(s)              # every delta link must resolve
            except FileNotFoundError:
                continue
            complete.append(s)
        if complete:
            arr = np.array(complete, np.int32)
            self.index.insert(arr, np.ones_like(arr))
