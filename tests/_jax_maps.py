"""Keeps a test process under the kernel's memory-map limit.

Every XLA executable holds memory maps of its own, and a process may hold
at most ``vm.max_map_count`` (65530 by default); a process that compiles
past it dies in the compiler (a segfault or an abort, not an exception).
The JAX package's own test files compile the store at many widths:
``test_bulk_apply.py`` and ``test_range_property.py`` run in one process
reach about 63,000 maps.  Which files share an xdist worker depends on how
the tests are dealt out, so the limit is kept for every test, not only for
those of the parity modules.

A plugin: the parity modules name it in ``pytest_plugins``, and collecting
any of them registers it for the whole run.
"""

from __future__ import annotations

import jax

MAX_MAPS = 40_000


def _map_count() -> int:
    """Memory maps this process holds (lines of ``/proc/self/maps``); 0
    where the file does not exist."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0


def pytest_runtest_setup(item):
    """Free JAX's compiled executables before a test once the process
    holds more than ``MAX_MAPS`` memory maps.  Only between tests, so a
    test that counts its own compilations sees every one of them.
    Checking costs one read of the maps file."""
    if _map_count() > MAX_MAPS:
        jax.clear_caches()
