"""kill -9 fault injection for the durability battery.

A port of the crash-point half of the JAX package's
``repro.distributed.fault``, under the same environment selector, so one
battery drives both packages alike: named points on the WAL append /
fsync / checkpoint publish paths SIGKILL the process mid-operation when
``URUV_CRASH_POINT`` selects them, and recovery is exercised against
genuinely torn on-disk state, not a polite exception.  (The straggler
monitor, ``reshard`` and ``run_with_restarts`` of that module belong to
training and sharding, which the port does not carry yet.)
"""

from __future__ import annotations

import os
import signal
from typing import Callable, Dict, Optional

CRASH_POINT_ENV = "URUV_CRASH_POINT"

# per-process hit counters, keyed by crash-point name — the env selector
# ``name:k`` crashes on the k-th time execution reaches ``name``
_crash_hits: Dict[str, int] = {}


def reset_crash_counters() -> None:
    """Forget per-process crash-point hit counts (test isolation)."""
    _crash_hits.clear()


def crash_point(name: str, flush: Optional[Callable[[], None]] = None) -> None:
    """Die by SIGKILL when the ``URUV_CRASH_POINT`` selector matches.

    The selector is ``<name>`` (crash on the first hit) or ``<name>:<k>``
    (crash on the k-th hit — randomized crash timing without randomizing
    the code path).  ``flush`` runs right before the kill so deliberately
    torn state (e.g. a half-written WAL record sitting in a userspace
    buffer) actually reaches the OS file — SIGKILL forfeits every Python
    buffer, which would otherwise make the torn-write points unreachable.

    A no-op (one dict lookup) when the env var is unset, so the hooks are
    safe to leave on production paths.
    """
    sel = os.environ.get(CRASH_POINT_ENV)
    if not sel:
        return
    want, _, k = sel.partition(":")
    if want != name:
        return
    hits = _crash_hits.get(name, 0) + 1
    _crash_hits[name] = hits
    if hits < (int(k) if k else 1):
        return
    if flush is not None:
        flush()
    os.kill(os.getpid(), signal.SIGKILL)
