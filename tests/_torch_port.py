"""Shared helpers of the JAX-vs-PyTorch parity tests (tests/test_torch_*).

A JAX store is flattened to numpy by field name — index fields as
``index.<name>``, index levels as ``index.<name>.<l>`` — the layout of
``repro_torch.core.store.to_numpy`` / ``from_numpy``, so a state carries
across in both directions and two stores compare array by array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """Free JAX's compiled executables before and after a parity module.

    Every XLA executable holds memory maps of its own, and a process
    may hold at most ``vm.max_map_count`` (65530 by default); a test
    worker that compiles past it dies in the compiler.  The parity tests
    compile the JAX store at widths of their own, so each module starts
    from and leaves behind a worker with no compiled executables.
    """
    jax.clear_caches()
    yield
    jax.clear_caches()


def jax_arrays(store) -> dict:
    """Every array of a JAX ``UruvStore``, numpy, keyed by field name."""
    s = jax.device_get(store)
    out = {}
    for f in dataclasses.fields(s):
        if f.name == "cfg":
            continue
        v = getattr(s, f.name)
        if f.name == "index":
            for g in dataclasses.fields(v):
                if g.name == "cfg":
                    continue
                w = getattr(v, g.name)
                if isinstance(w, tuple):
                    for l, a in enumerate(w):
                        out[f"index.{g.name}.{l}"] = np.asarray(a)
                else:
                    out[f"index.{g.name}"] = np.asarray(w)
            continue
        out[f.name] = np.asarray(v)
    return out


def port_config(jax_cfg):
    """The port's ``UruvConfig`` with the same capacities."""
    from repro_torch.core.store import UruvConfig

    return UruvConfig(**dataclasses.asdict(jax_cfg))


def to_port(jax_store, device="cpu"):
    """The JAX store's state as a port store."""
    from repro_torch.core.store import from_numpy

    return from_numpy(jax_arrays(jax_store), port_config(jax_store.cfg),
                      device)


def assert_same_arrays(a: dict, b: dict, where: str = "") -> None:
    """Bit-equal arrays under identical names (and dtypes)."""
    assert sorted(a) == sorted(b), (where, sorted(set(a) ^ set(b)))
    for name in a:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype, (where, name, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{where}: {name}")


def assert_same_store(jax_store, port_store, where: str = "") -> None:
    from repro_torch.core.store import to_numpy

    assert_same_arrays(jax_arrays(jax_store), to_numpy(port_store), where)


# ---------------------------------------------------------------------------
# The JAX package's sharded code on one CPU device
# ---------------------------------------------------------------------------

def vmap_shard_map(f, *, mesh, in_specs, out_specs, **_):
    """A stand-in for ``shard_map`` over ``jax.vmap`` along the mesh's one
    axis: a ``P(axis)`` argument is split along a leading shard axis, a
    ``P()`` / ``P(None)`` argument is shared, a ``P(axis)`` output is the
    shards' blocks concatenated and a ``P()`` output is shard 0's.

    jax 0.9's ``shard_map`` rejects the JAX store's ``lax.cond`` over
    varying manual axes ("cond branches must have equal output types"),
    so the JAX package's sharded tests fail under it; under ``vmap`` the
    collectives (``psum``, ``all_gather``, ``all_to_all``,
    ``axis_index``) keep their meaning and the package's own
    ``make_apply`` / ``make_routed_apply`` / ``make_range_apply`` /
    ``make_ops`` and ``ShardedExecutor`` run unchanged."""
    (axis, n), = mesh.shape.items()

    def split(spec):
        return len(spec) > 0 and spec[0] == axis

    def wrapped(*args):
        args = [jax.tree.map(lambda x: x.reshape((n, -1) + x.shape[1:]), a)
                if split(s) else a for a, s in zip(args, in_specs)]
        outs = jax.vmap(f, in_axes=tuple(0 if split(s) else None
                                         for s in in_specs),
                        axis_name=axis)(*args)
        single = not isinstance(out_specs, tuple)
        outs, specs = ((outs,), (out_specs,)) if single else (outs, out_specs)
        merged = tuple(
            jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), o)
            if split(s) else jax.tree.map(lambda x: x[0], o)
            for o, s in zip(outs, specs))
        return merged[0] if single else merged

    return wrapped


class FakeMesh:
    """What the JAX sharded code reads of a mesh: ``shape[axis]``."""

    def __init__(self, n: int, axis: str = "data"):
        self.shape = {axis: n}


def emulate_jax_sharding(monkeypatch) -> None:
    """Run the JAX package's sharded code through :func:`vmap_shard_map`
    (its ``shard_map``) and make ``ShardedExecutor._reshard`` the identity
    (there is no mesh to pin to)."""
    import repro.api.executors as JE
    import repro.core.sharded as JS

    monkeypatch.setattr(JS, "shard_map", vmap_shard_map)
    monkeypatch.setattr(JE.ShardedExecutor, "_reshard", lambda self, st: st)


def jax_stacked_store(base_cfg, n: int):
    """A JAX stacked store of ``n`` empty shards (``sharded.create`` needs
    a real mesh): ``S.create(base_cfg)`` broadcast along a shard axis."""
    import jax.numpy as jnp
    from repro.core import store as JS

    return jax.tree.map(lambda x: jnp.array(jnp.broadcast_to(
        x, (n,) + x.shape)), JS.create(base_cfg))
