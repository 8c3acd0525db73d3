"""Activation-sharding context.

A port of the JAX package's ``repro.distributed.ctx``.  Model code calls
``shard_act(x, kind)`` at a few key points (residual stream, logits, KV
cache, MoE dispatch).  Outside a mesh context these are no-ops.  The dry
run (``repro_torch.launch.dryrun``) installs the context with
``use_mesh``; inside it ``shard_act`` still returns ``x`` itself (the
port keeps a tensor's shards on one device, so there is no constraint to
place) and records ``(kind, shape, guarded spec, local shape)`` for the
dry run's report; the dry run's spec pass (``distributed.spmd``) listens
there for the constraint.

Kinds (axes refer to the production mesh, ``launch.mesh``):
  residual  [B, S, D]      B -> (pod, data);  S -> model if sequence_parallel
  tokens    [B, S]         B -> (pod, data)
  logits    [B, S, V]      B -> (pod, data);  V -> model
  kv_cache  [L, B, KVH, S, D]   B -> (pod, data);  S -> model
  seq_shard [..., S, ...]  long-context decode: S over every mesh axis
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Optional, Tuple

from repro_torch.distributed.sharding import Spec, local_shape

_CTX: contextvars.ContextVar[Optional["ShardCtx"]] = contextvars.ContextVar(
    "repro_torch_shard_ctx", default=None
)


class ShardCtx:
    def __init__(self, mesh, *, sequence_parallel: bool = True,
                 long_context: bool = False):
        self.mesh = mesh
        self.sequence_parallel = sequence_parallel
        self.long_context = long_context
        names = mesh.axis_names
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in names
        )
        self.model_axis: Optional[str] = "model" if "model" in names else None
        # (kind, shape, guarded spec, local shape) of every shard_act call
        self.records: List[tuple] = []
        # called as listener(x, kind) at every shard_act (the dry run's
        # spec pass, distributed.spmd)
        self.listener: Optional[Callable] = None

    def spec(self, kind: str, ndim: int) -> Optional[Spec]:
        ba = self.batch_axes
        # canonical spec entries: bare axis name unless compound
        b = (ba[0] if len(ba) == 1 else ba) if ba else None
        m = self.model_axis
        sp = m if self.sequence_parallel else None
        if kind == "residual":
            return (b, sp, None)
        if kind == "tokens":
            return (b, None)
        if kind == "logits":
            return (b, None, m)
        if kind == "kv_cache":
            return (None, b, None, m, None)
        if kind == "ssm_state":  # [L, B, heads, ...]
            return (None, b, m, *([None] * (ndim - 3)))
        if kind == "moe_tokens":      # [T, D] flattened tokens pre-dispatch
            return (b, None)
        if kind == "moe_experts":     # [E, C, D] dispatched expert blocks
            return (m, b, None)       # EP over model, capacity over data
        if kind == "moe_weight":      # [E, D, F] gather-on-use (ZeRO): drop
            return (m, None, None)    # the FSDP axis inside the layer
        if kind == "kv4":
            # per-layer decode cache [B, KVH, S, hd] — matches the cache's
            # resident layout (batch over data, seq over model;
            # long-context: seq over every axis)
            if self.long_context:
                all_axes = ba + ((m,) if m else ())
                return (None, None, all_axes if all_axes else None, None)
            return (b, None, m, None)
        if kind == "seq_shard":
            # batch=1 long-context: sequence over the whole mesh
            all_axes = ba + ((m,) if m else ())
            spec = [None] * ndim
            spec[-2] = all_axes if all_axes else None
            return tuple(spec)
        return None


@contextlib.contextmanager
def use_mesh(mesh, *, sequence_parallel: bool = True,
             long_context: bool = False):
    """Install a :class:`ShardCtx` for ``mesh`` (None: no context) for the
    body; yields it (None without a mesh)."""
    ctx = (ShardCtx(mesh, sequence_parallel=sequence_parallel,
                    long_context=long_context) if mesh else None)
    tok = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(tok)


def _guard(spec: Spec, shape, mesh) -> Spec:
    """Drop axes that do not divide the corresponding dim (replicate)."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        out.append(entry if shape[d] % n == 0 else None)
    return tuple(out)


def shard_act(x, kind: str):
    """``x`` itself; under ``use_mesh`` the call is also recorded with
    the spec the JAX package would constrain ``x`` to, and told to the
    context's ``listener``."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    spec = ctx.spec(kind, x.dim())
    if spec is None:
        return x
    shape = tuple(x.shape)
    spec = _guard(spec, shape, ctx.mesh)
    ctx.records.append((kind, shape, spec,
                        local_shape(shape, spec, ctx.mesh)))
    if ctx.listener is not None:
        ctx.listener(x, kind)
    return x
