"""The sharded store's collectives over a ``torch.distributed`` group.

The port's counterparts of the JAX package's ``lax.axis_index``,
``psum``, ``pmax``, ``all_gather`` and ``all_to_all`` (``split_axis=0,
concat_axis=0``), for the int32, int64 and float32 tensors of
``repro_torch.core.sharded`` and ``repro_torch.optim.compression``: one
process a shard, and the group's members the devices of the JAX mesh
axis.  Every function returns a new tensor (its input is left as it
was), on its input's device.

The group's backend is the caller's choice (``gloo`` or ``nccl``), never
made here, and one code path serves both:

  * NCCL has no bitwise reduction, so the OR of ``OFLOW_*`` bits
    (:func:`bitwise_or`) is an ``all_gather`` followed by an OR, on
    every backend.
  * gloo takes CUDA tensors for every collective used here, so none is
    staged through a host tensor by this module: on an NVIDIA H100 with
    torch 2.11.0+cu128, ``scripts/gloo_cuda_probe.py`` found
    ``all_reduce`` (SUM, MAX), ``all_gather`` and ``all_to_all_single``
    taken on CUDA tensors by a 4-process gloo group and answering right
    at int32, int64 and float32 (gloo copies them through host memory
    itself).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_index(group) -> int:
    """This process's index along the group (JAX's ``lax.axis_index``)."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    t = x.clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group (JAX's ``lax.psum``)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group (``lax.pmax``)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``x`` stacked in rank order: ``[n, *x.shape]``
    (JAX's ``lax.all_gather`` along a new leading axis)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.stack(out)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``lax.all_to_all(x, split_axis=0, concat_axis=0)``: ``x`` is
    ``[n, ...]``; row ``d`` goes to member ``d``, and row ``s`` of the
    answer came from member ``s``."""
    if x.shape[0] != axis_size(group):
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} is not "
                         f"the group's size {axis_size(group)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def bitwise_or(x: torch.Tensor, group) -> torch.Tensor:
    """The bitwise OR of an integer ``x`` over the group: an
    ``all_gather`` and an OR here (NCCL has no bitwise reduction)."""
    parts = all_gather(x, group)
    out = parts[0]
    for p in parts[1:]:
        out = out | p
    return out


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every member's rows of ``x`` (``[m_r, ...]``, ``m_r`` its own)
    concatenated in rank order: the row counts first, then the rows padded
    to the longest."""
    m = all_gather(torch.tensor([x.shape[0]], device=x.device), group)
    m = m.reshape(-1).tolist()
    pad = torch.zeros((max(m) - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    parts = all_gather(torch.cat([x, pad]), group)
    return torch.cat([p[:k] for p, k in zip(parts, m)])


def barrier(group) -> None:
    dist.barrier(group=group)
