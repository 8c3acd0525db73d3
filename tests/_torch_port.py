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
