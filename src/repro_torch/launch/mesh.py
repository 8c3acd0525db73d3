"""Meshes: the sharded store's, and the production mesh of the dry run.

A port of the JAX package's ``repro.launch.mesh``.  A :class:`Mesh`
names its axes and their sizes (``mesh.shape[axis]``, as a JAX mesh
gives them) and the one device every shard lives on: the shards of a
stacked store (``repro_torch.core.sharded``), n stores stacked on that
device for a data axis of size n; or ``meta`` for the production mesh,
whose chips the dry run (``launch.dryrun``) counts and never touches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.store import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]          # axis name -> size
    axis_names: Tuple[str, ...]
    device: torch.device


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh whose shards live on ``device`` (default
    ``cuda``; raises without it, ``device="cpu"`` for the plain path)."""
    return Mesh(shape={"data": data, "model": model},
                axis_names=("data", "model"),
                device=resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 chips per pod; the multi-pod mesh adds a leading pod axis.
    Its device is ``meta``: a layout to count per-chip bytes against."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape=dict(zip(axes, shape)), axis_names=axes,
                device=torch.device("meta"))
