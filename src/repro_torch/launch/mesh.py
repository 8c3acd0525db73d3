"""Meshes: the sharded store's, and the production mesh of the dry run.

A port of the JAX package's ``repro.launch.mesh``.  A :class:`Mesh`
names its axes and their sizes (``mesh.shape[axis]``, as a JAX mesh
gives them) and a device.  Three kinds:

  * one process, ``group`` None: the n shards of a stacked store
    (``repro_torch.core.sharded``) all live on ``device``;
  * one process a shard, ``group`` a ``torch.distributed`` process group
    whose size is the data axis: this process holds shard ``rank`` on
    ``device``, and the passes' collectives run over the group;
  * ``meta`` for the production mesh, whose chips the dry run
    (``launch.dryrun``) counts and never touches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.store import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]          # axis name -> size
    axis_names: Tuple[str, ...]
    device: torch.device           # with a group: this process's device
    group: Optional[Any] = None    # torch.distributed group of the data axis


def make_host_mesh(data: int = 1, model: int = 1, device=None,
                   group=None) -> Mesh:
    """A ``(data, model)`` mesh on ``device`` (default ``cuda``; raises
    without it, ``device="cpu"`` for the plain path).  With ``group`` (a
    ``torch.distributed`` process group, its size ``data``) each member
    process holds one shard on its own ``device``."""
    if group is not None:
        import torch.distributed as dist

        if dist.get_world_size(group) != data:
            raise ValueError(f"the group has {dist.get_world_size(group)} "
                             f"members, the data axis {data}")
    return Mesh(shape={"data": data, "model": model},
                axis_names=("data", "model"),
                device=resolve_device(device), group=group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 chips per pod; the multi-pod mesh adds a leading pod axis.
    Its device is ``meta``: a layout to count per-chip bytes against."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape=dict(zip(axes, shape)), axis_names=axes,
                device=torch.device("meta"))
