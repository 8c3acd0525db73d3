"""Meshes for the sharded store.

A port of the host half of the JAX package's ``repro.launch.mesh``.  A
:class:`Mesh` names its axes and their sizes (``mesh.shape[axis]``, as a
JAX mesh gives them) and the one device every shard of a stacked store
lives on (``repro_torch.core.sharded``): the shards of a data axis of
size n are n stores stacked on that device.
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
