"""Plain PyTorch twin of the versioned_read kernel (device-agnostic)."""

from __future__ import annotations

import torch

from repro_torch.core.ref import NOT_FOUND, TOMBSTONE


def _walk(cur, snap, ver_ts, ver_next, max_chain: int):
    """The bounded chain walk: advance while the version is newer than
    the snapshot, at most ``max_chain`` steps.  Indices clamp into the
    pool like the JAX reference's gathers."""
    n_ver = ver_ts.shape[0]
    for _ in range(max_chain):
        safe = cur.clamp(0, n_ver - 1)
        adv = (cur >= 0) & (ver_ts[safe] > snap)
        # a step that does not advance is a fixed point; testing for it
        # is free on the host but would sync the card every step
        if cur.device.type == "cpu" and not bool(adv.any()):
            break
        cur = torch.where(adv, ver_next[safe], cur)
    return cur


def _read(cur, snap, ver_ts, ver_value):
    safe = cur.clamp(0, ver_ts.shape[0] - 1)
    ok = (cur >= 0) & (ver_ts[safe] <= snap)
    val = torch.where(ok, ver_value[safe], NOT_FOUND)
    return torch.where(val == TOMBSTONE, NOT_FOUND, val)


def versioned_read_ref(vhead, snap_ts, ver_ts, ver_next, ver_value, *,
                       max_chain: int):
    """First version with ts <= snap along each chain (at most
    ``max_chain`` steps); NOT_FOUND when none or a tombstone."""
    snap = snap_ts.expand(vhead.shape)
    cur = _walk(vhead, snap, ver_ts, ver_next, max_chain)
    return _read(cur, snap, ver_ts, ver_value)
