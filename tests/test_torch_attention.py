"""The port's attention twins against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro.kernels.flash_attention`` /
``decode_attention`` (Pallas, interpret mode on the CPU, as
``tests/test_kernels.py`` runs them) and through the port's wrappers on
CPU tensors, which take the plain twins.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in fp32, 2e-2 in bf16.  The twins copy the
TPU kernels' edge conventions (a row with no unmasked key gives 0), which
the JAX oracle ``attention_ref`` does not; those rows are compared with
the kernel only.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention as j_decode,
)
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention as j_flash,
)
from repro.kernels.flash_attention.ref import attention_ref as j_aref

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention,
)
from repro_torch.kernels.decode_attention.ops import decode
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import attention

from _torch_port import fresh_jax_caches  # noqa: F401  (autouse)

RNG = np.random.default_rng(7)


def _both(a, dtype):
    """(jax array, torch tensor) of one numpy array in ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()
    return jnp.asarray(a), torch.tensor(a)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KVH,S,D,causal,win,dtype", [
    (2, 4, 2, 96, 32, True, 0, "float32"),
    (2, 8, 4, 80, 32, True, 24, "float32"),
    (1, 4, 1, 64, 16, False, 0, "float32"),
    (1, 4, 2, 64, 32, True, 16, "bfloat16"),
])
def test_flash_twin_matches_pallas_kernel(B, H, KVH, S, D, causal, win,
                                          dtype):
    arrs = [RNG.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrs)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    n0 = sum(_build.launch_counts.values())
    got = attention(tq, tk, tv, causal=causal, window=win)
    assert sum(_build.launch_counts.values()) == n0   # the twin: no launch
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, j_flash(jq, jk, jv, causal=causal, window=win,
                        block_q=32, block_k=32), tol)
    _close(got, j_aref(jq, jk, jv, causal=causal, window=win), tol)


@pytest.mark.parametrize("B,H,KVH,S,D,bk", [
    (3, 8, 2, 100, 32, 32), (1, 8, 1, 130, 64, 64),
])
def test_decode_twin_matches_pallas_kernel(B, H, KVH, S, D, bk):
    q = RNG.standard_normal((B, H, D)).astype(np.float32)
    k = RNG.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = RNG.standard_normal((B, KVH, S, D)).astype(np.float32)
    lens = RNG.integers(1, S + 1, B).astype(np.int32)
    got = decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                 torch.tensor(lens))
    args = tuple(map(jnp.asarray, (q, k, v, lens)))
    _close(got, j_decode(*args, block_k=bk), 2e-5)
    _close(got, j_dref(*args), 2e-5)
    # bf16 inputs (the KV cache's type on the serve path)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.tensor(x).bfloat16() for x in (q, k, v)]
    got_b = decode_attention(*tb, torch.tensor(lens))
    assert got_b.dtype == torch.bfloat16
    _close(got_b, j_decode(*jb, jnp.asarray(lens), block_k=bk), 2e-2)


def test_decode_stats_split_kv_combine():
    """Combining per-half (out, m, l) equals the whole-cache result and
    matches the Pallas kernel's own stats."""
    B, H, KVH, S, D = 2, 4, 2, 64, 16
    q = RNG.standard_normal((B, H, D)).astype(np.float32)
    k = RNG.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = RNG.standard_normal((B, KVH, S, D)).astype(np.float32)
    full = decode_attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), torch.full((B,), S,
                                                        dtype=torch.int32))
    halves = []
    for sl in (slice(0, S // 2), slice(S // 2, S)):
        n = torch.full((B,), S // 2, dtype=torch.int32)
        o, m, l = decode_attention(torch.tensor(q),
                                   torch.tensor(k[:, :, sl]).contiguous(),
                                   torch.tensor(v[:, :, sl]).contiguous(),
                                   n, return_stats=True)
        jo, jm, jl = j_decode(jnp.asarray(q), jnp.asarray(k[:, :, sl]),
                              jnp.asarray(v[:, :, sl]),
                              jnp.full((B,), S // 2, jnp.int32),
                              block_k=16, return_stats=True)
        assert m.shape == l.shape == (B, H, 1)
        _close(m, jm, 2e-5)
        _close(l, jl, 2e-5)
        halves.append([x.double().numpy() for x in (o, m, l)])
    (o1, m1, l1), (o2, m2, l2) = halves
    m = np.maximum(m1, m2)
    l = l1 * np.exp(m1 - m) + l2 * np.exp(m2 - m)
    o = (o1 * (l1 * np.exp(m1 - m)) + o2 * (l2 * np.exp(m2 - m))) / l
    np.testing.assert_allclose(o, full.double().numpy(), atol=1e-5,
                               rtol=1e-5)


def test_masked_row_convention_follows_the_kernel():
    """A row with no unmasked key gives 0, as the Pallas kernel does (the
    JAX oracle gives the mean of v there); a sequence of length 0 gives 0
    with m = -1e30 and l = 0."""
    q = RNG.standard_normal((1, 2, 16, 8)).astype(np.float32)
    k = RNG.standard_normal((1, 1, 4, 8)).astype(np.float32)
    v = RNG.standard_normal((1, 1, 4, 8)).astype(np.float32)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=False, window=2)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False, window=2, block_q=8, block_k=4)
    _close(got, want, 2e-5)
    assert torch.all(got[:, :, 5:] == 0)             # qi - 3 >= 2: no key
    oracle = np.asarray(j_aref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False, window=2))
    _close(got[:, :, :5], oracle[:, :, :5], 2e-5)
    assert not np.allclose(oracle[:, :, 5:], 0)

    qd = RNG.standard_normal((2, 2, 8)).astype(np.float32)
    kd = RNG.standard_normal((2, 1, 6, 8)).astype(np.float32)
    lens = np.array([0, 3], np.int32)
    o, m, l = decode_attention(torch.tensor(qd), torch.tensor(kd),
                               torch.tensor(kd), torch.tensor(lens),
                               return_stats=True)
    jo, jm, jl = j_decode(jnp.asarray(qd), jnp.asarray(kd), jnp.asarray(kd),
                          jnp.asarray(lens), block_k=2, return_stats=True)
    _close(o, jo, 2e-5)
    assert torch.all(o[0] == 0) and torch.all(l[0] == 0)
    assert torch.all(m[0] == -1e30)
    _close(m, jm, 2e-5)
    _close(l, jl, 2e-5)


def test_wrappers_refuse_other_devices_and_bad_shapes():
    q = torch.zeros(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="device"):
        decode_attention(q[:, :, 0], q[:, :1], q[:, :1],
                         torch.zeros(1, dtype=torch.int32, device="meta"))
