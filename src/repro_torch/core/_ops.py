"""Tensor idioms the port needs to reproduce the JAX reference exactly.

* int32 throughout: ``arange32``/``cumsum32`` keep PyTorch from widening
  to int64, so every store field comes out with the reference's dtype.
* Dropped writes: JAX's ``x.at[i].set(v, mode="drop")`` silently skips an
  out-of-range index, which the reference uses as a sink (index ML, MV,
  or a column past the row).  PyTorch raises instead (a device assert on
  CUDA), so writes go into a fresh flat copy of ``x`` with ONE spare slot
  at the end, every dropped write is aimed at that slot, and the slot is
  cut off afterwards (:func:`sinked`, :func:`put`, :func:`unsink`).  The
  copy also keeps every write away from the input tensors, which stay
  valid snapshots (the combining layer reuses the pre-pass store after a
  rejection).  No boolean-mask indexing: it would sync the host for the
  result's size.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def arange32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=I32)


def cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def shifted(x: torch.Tensor, fill) -> torch.Tensor:
    """``[fill, x[0], ..., x[-2]]`` — the element before each position."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def ahead(x: torch.Tensor, fill) -> torch.Tensor:
    """``[x[1], ..., x[-1], fill]`` — the element after each position."""
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype,
                                        device=x.device)])


def jax_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Gather index with the reference's semantics: a negative index
    wraps once by ``n``, then the index is clamped into ``[0, n)``."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def sinked(x: torch.Tensor) -> torch.Tensor:
    """A fresh flat copy of ``x`` with one spare sink slot at the end."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[:-1] = x.reshape(-1)
    return buf


def unsink(buf: torch.Tensor, shape) -> torch.Tensor:
    """The live part of a :func:`sinked` buffer, as a contiguous view."""
    return buf[:-1].view(shape)


def put(buf: torch.Tensor, lin: torch.Tensor, vals) -> None:
    """``buf[lin] = vals`` in place; ``lin`` from the ``lin_*`` helpers
    (dropped writes already aimed at the sink slot)."""
    if not torch.is_tensor(vals):
        vals = torch.tensor(vals, dtype=buf.dtype, device=buf.device)
    buf.index_put_((lin.reshape(-1),), vals.to(buf.dtype).expand(lin.shape)
                   .reshape(-1))


def lin_1d(i: torch.Tensor, n: int) -> torch.Tensor:
    """Linear index of ``x[i]`` for ``x`` of length ``n``; ``i`` outside
    ``[0, n)`` drops."""
    i = i.long()
    return torch.where((i >= 0) & (i < n), i, n)


def lin_elem(r: torch.Tensor, c: torch.Tensor, n_rows: int,
             n_cols: int) -> torch.Tensor:
    """Linear index of ``x[r, c]`` in a row-major ``[n_rows, n_cols]``;
    either index out of range drops."""
    r, c = r.long(), c.long()
    ok = (r >= 0) & (r < n_rows) & (c >= 0) & (c < n_cols)
    return torch.where(ok, r * n_cols + c, n_rows * n_cols)


def lin_rows(rows: torch.Tensor, n_rows: int, width: int) -> torch.Tensor:
    """Linear indices [N, width] of whole rows ``x[rows, :]``; a row
    outside ``[0, n_rows)`` drops."""
    rows = rows.long()
    cols = torch.arange(width, device=rows.device)
    ok = ((rows >= 0) & (rows < n_rows))[:, None]
    return torch.where(ok, rows[:, None] * width + cols, n_rows * width)


def drop_set(x: torch.Tensor, lin: torch.Tensor, vals) -> torch.Tensor:
    """A new tensor equal to ``x`` with one dropped-write scatter applied."""
    buf = sinked(x)
    put(buf, lin, vals)
    return unsink(buf, x.shape)


def sort_rows(keys: torch.Tensor, payload: torch.Tensor):
    """Sort each row of ``keys`` (stable) and carry ``payload`` along."""
    skeys, perm = torch.sort(keys, dim=1, stable=True)
    return skeys, payload.gather(1, perm)
