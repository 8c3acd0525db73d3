"""Sharding rules: param-name-pattern -> partition spec, with guards.

A port of the JAX package's ``repro.distributed.sharding``.  DP over
(pod, data); TP over model (Megatron column/row); EP for MoE experts
over model; FSDP (params + optimizer state over data) optional; SP for
the residual stream handled by ``repro_torch.distributed.ctx``.

Every rule is guarded by divisibility — a dim that does not divide by its
mesh axis falls back to replication, so all ten architectures lay out on
the same mesh without per-arch special cases.

A spec is a tuple with one entry per dim: ``None`` (replicated), an axis
name, or a tuple of axis names (the dim split over their product) — the
entries of a JAX ``PartitionSpec``.  A mesh is anything with ``shape``
(axis name -> size) and ``axis_names``: ``launch.mesh.Mesh`` here.  The
port keeps every shard of a tensor on one device, so nothing here moves
data: the dry run (``launch.dryrun``) reads the specs to count per-chip
bytes (:func:`local_shape`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

Spec = Tuple  # one entry per dim: None | axis name | tuple of axis names


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True           # shard params/opt-state over data axis too
    sequence_parallel: bool = True


def _ax(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _fits(shape, dim, n) -> bool:
    return 0 <= dim < len(shape) and shape[dim] % n == 0 and shape[dim] >= n


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               policy: ShardingPolicy) -> Spec:
    """Sharding for one parameter, identified by its tree path."""
    model_n = _ax(mesh, "model")
    data_axes = _batch_axes(mesh)
    data_n = 1
    for a in data_axes:
        data_n *= mesh.shape[a]
    nd = len(shape)
    spec = [None] * nd
    name = path.split("/")[-1]

    def set_model(dim: int) -> bool:
        d = dim % nd
        if model_n > 1 and _fits(shape, d, model_n) and spec[d] is None:
            spec[d] = "model"
            return True
        return False

    def set_fsdp(preferred: Tuple[int, ...]):
        if not policy.fsdp or data_n <= 1:
            return
        for dim in preferred:
            d = dim % nd
            if spec[d] is None and _fits(shape, d, data_n):
                spec[d] = data_axes if len(data_axes) > 1 else data_axes[0]
                return

    if name in ("embed",):                      # [V, D]
        set_model(-2)
        set_fsdp((-1,))
    elif name in ("unembed",):                  # [D, V]
        set_model(-1)
        set_fsdp((-2,))
    elif name in ("wq", "wk", "wv"):            # [*, D, H|KVH, hd]
        if not set_model(-2):                   # heads over model (TP)
            set_model(-3)                       # else contract dim
        set_fsdp((-3, -1))
    elif name == "wo":                          # [*, H, hd, D]
        set_model(-3)
        set_fsdp((-1,))
    elif name in ("w1", "w3", "up", "in_proj"):  # [*, (E,) D, F]
        if len(shape) >= 4 or "moe" in path:    # moe experts [*, E, D, F]
            set_model(-3)                       # EP: experts over model
            set_fsdp((-1,))
        else:
            set_model(-1)                       # column parallel
            set_fsdp((-2,))
    elif name in ("w2", "out_proj", "down", "out"):  # [*, (E,) F, D]
        if "moe" in path and len(shape) >= 4:
            set_model(-3)
            set_fsdp((-2,))
        else:
            set_model(-2)                       # row parallel
            set_fsdp((-1,))
    elif name == "conv_w":                      # [*, K, C]
        set_model(-1)
    elif name in ("W",):                        # slstm [*, d, nh, 4, hd]
        set_model(-1)
        set_fsdp((-4,))
    elif name in ("R",):                        # slstm [*, nh, hd, 4, hd]
        set_model(-1)
    elif name == "router":                      # [*, D, E]
        set_fsdp((-2,))
    # 1-D / small params (norm scales, biases, gates): replicate.
    return tuple(spec)


def tree_map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists (a
    ``NamedTuple``'s fields by name), ``path`` the keys and indices from
    the root as strings: ``jax.tree_util.tree_map_with_path`` over the
    port's trees, with the names the JAX rules read."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(param_tree, mesh, policy: ShardingPolicy):
    """Tree of specs congruent with ``param_tree``."""
    return tree_map_with_path(
        lambda path, leaf: param_spec("/".join(path), tuple(leaf.shape),
                                      mesh, policy), param_tree)


def batch_specs(batch_tree, mesh, *, long_context: bool = False):
    """Specs for step inputs (tokens/labels/patches/cache/...)."""
    b = _batch_axes(mesh)
    b = b if len(b) > 1 else (b[0] if b else None)
    model = "model" if "model" in mesh.axis_names else None

    def visit(names, leaf):
        top = names[0] if names else ""
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if top in ("k", "v", "attn_k", "attn_v") or "cache" in names[:2]:
            # KV cache [L, B, KVH, S, hd] or ssm state [L, B, H, ...]
            if nd == 5 and shape[3] > 256:   # kv cache: seq dim big
                if long_context:
                    spec[3] = tuple(a for a in ("pod", "data", "model")
                                    if a in mesh.axis_names)
                else:
                    if shape[1] % _pn(mesh, b) == 0:
                        spec[1] = b
                    if model and shape[3] % mesh.shape["model"] == 0:
                        spec[3] = model
            else:
                if nd >= 2 and not long_context and shape[1] % _pn(mesh, b) == 0:
                    spec[1] = b
                if (nd >= 3 and model
                        and shape[2] % mesh.shape["model"] == 0):
                    spec[2] = model
        else:
            # plain batch-major arrays: tokens/labels/mask/embeds/patches
            if nd >= 1 and shape[0] % _pn(mesh, b) == 0:
                spec[0] = b
            if top == "embeds" and nd == 3 and model and (
                    shape[1] % mesh.shape["model"] == 0):
                spec[1] = model   # SP on provided frame embeddings
        return tuple(spec)

    return tree_map_with_path(visit, batch_tree)


def _pn(mesh, b) -> int:
    if b is None:
        return 1
    if isinstance(b, str):
        return mesh.shape[b]
    n = 1
    for a in b:
        n *= mesh.shape[a]
    return n


def local_shape(shape, spec: Optional[Spec], mesh) -> Tuple[int, ...]:
    """One chip's block of a tensor of ``shape`` laid out by ``spec`` on
    ``mesh`` (``NamedSharding.shard_shape``): each sharded dim divided by
    the product of its axes' sizes.  Raises where a dim does not divide."""
    shape = tuple(int(d) for d in shape)
    if spec is None:
        return shape
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = _pn(mesh, entry)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {shape} does not divide over "
                             f"{entry} ({n})")
        out[d] = shape[d] // n
    return tuple(out)
