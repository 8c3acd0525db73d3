"""Plain PyTorch twin of the uruv_range kernel (device-agnostic)."""

from __future__ import annotations

import torch

from repro_torch.core._ops import jax_index
from repro_torch.core.ref import KEY_MAX, NOT_FOUND
from repro_torch.kernels.versioned_read.ref import versioned_read_ref


def range_scan_ref(lids, pvalid, k1, k2, snap_ts, leaf_keys, leaf_vhead,
                   leaf_count, ver_ts, ver_next, ver_value, *,
                   max_chain: int):
    """Candidate keys/values of Q leaf windows, each [Q, S*L]: hits carry
    (key, value at the query's snapshot), non-hits (KEY_MAX, NOT_FOUND)."""
    Q, S = lids.shape
    ML, L = leaf_keys.shape
    li = jax_index(lids, ML)
    rows = leaf_keys[li]                                    # [Q, S, L]
    cnt = leaf_count[li]
    slot_ok = torch.arange(L, device=lids.device) < cnt[..., None]
    cand = (pvalid[..., None] & slot_ok
            & (rows >= k1[:, None, None]) & (rows <= k2[:, None, None]))
    vh = torch.where(cand, leaf_vhead[li], -1)
    snap = snap_ts[:, None, None].expand(cand.shape)
    vals = versioned_read_ref(vh.reshape(-1), snap.reshape(-1), ver_ts,
                              ver_next, ver_value,
                              max_chain=max_chain).view(Q, S, L)
    hit = cand & (vals != NOT_FOUND)
    cand_keys = torch.where(hit, rows, KEY_MAX).view(Q, S * L)
    cand_vals = torch.where(hit, vals, NOT_FOUND).view(Q, S * L)
    return cand_keys, cand_vals
