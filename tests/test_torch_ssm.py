"""The port's SSD scan and its blocks against the JAX package's, on the CPU.

``ssd_chunked`` and ``ssd_recurrent_step`` get identical seeded inputs
on both sides and must agree at atol = rtol = 1e-5: both round every
product's operands to bf16 and multiply them exactly in fp32, so only
the order of summation differs.  The cases are a sequence of several
chunks, one shorter than its chunk, and the mLSTM's P = hd + 1 (the
normaliser as an extra column).  The port's chunked form also holds its
own recurrent form within 1e-2 of the output's max |y|, a bound for the
bf16 rounding of the chunked operands (no JAX test covers that pair).

The blocks (Mamba2, mLSTM, sLSTM), forward and one decode step each,
get the JAX block's weights through ``params_from_numpy``: fp32 at
atol = rtol = 1e-5 (decode states too).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.config import get_arch as j_get_arch
from repro.models import mamba2 as JM
from repro.models import xlstm as JX

from repro_torch.config import get_arch
from repro_torch.models import mamba2 as TM
from repro_torch.models import xlstm as TX
from repro_torch.models.registry import params_from_numpy, params_to_numpy

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

TOL = dict(atol=1e-5, rtol=1e-5)


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(0.5, 1.0, (B, S, H)).astype(np.float32),
            rng.standard_normal((B, S, H, N)).astype(np.float32),
            rng.standard_normal((B, S, H, N)).astype(np.float32))


SSD_CASES = [(2, 64, 3, 8, 8, 16), (2, 12, 3, 8, 8, 16),
             (1, 32, 2, 17, 16, 16)]
SSD_IDS = ["chunks", "short", "p_hd_plus_1"]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES, ids=SSD_IDS)
def test_ssd_chunked_matches_jax(B, S, H, P, N, chunk):
    args = _ssd_inputs(0, B, S, H, P, N)
    jy, jh = JM.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, th = TM.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES, ids=SSD_IDS)
def test_ssd_recurrent_matches_jax_and_chunked(B, S, H, P, N, chunk):
    """Each recurrent step against JAX's (state and output), and the
    port's recurrent outputs against its chunked ones."""
    u, a, Bm, Cm = _ssd_inputs(1, B, S, H, P, N)
    jh = jnp.zeros((B, H, P, N), jnp.float32)
    th = torch.zeros((B, H, P, N))
    ys = []
    for t in range(S):
        step = (u[:, t], a[:, t], Bm[:, t], Cm[:, t])
        jh, jy = JM.ssd_recurrent_step(jh, *map(jnp.asarray, step))
        th, ty = TM.ssd_recurrent_step(th, *map(torch.from_numpy, step))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        ys.append(ty)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    yc, hc = TM.ssd_chunked(*map(torch.from_numpy, (u, a, Bm, Cm)), chunk)
    yr = torch.stack(ys, 1)
    scale = float(yr.abs().max())
    assert float((yc - yr).abs().max()) <= 1e-2 * scale
    assert float((hc - th).abs().max()) <= 1e-2 * float(th.abs().max())


def _cfgs(arch):
    jcfg = j_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


BLOCKS = {
    # name: (arch, JAX init / fwd / state / decode, port fwd / state / decode)
    "mamba2": ("zamba2_2_7b", JM.init_block, JM.block_fwd, JM.init_state,
               JM.block_decode, TM.block_fwd, TM.init_state,
               TM.block_decode),
    "mlstm": ("xlstm_350m", JX.init_mlstm, JX.mlstm_fwd,
              JX.init_mlstm_state, JX.mlstm_decode, TX.mlstm_fwd,
              TX.init_mlstm_state, TX.mlstm_decode),
    "slstm": ("xlstm_350m", JX.init_slstm, JX.slstm_fwd,
              JX.init_slstm_state, JX.slstm_decode, TX.slstm_fwd,
              TX.init_slstm_state, TX.slstm_decode),
}


def _close_tree(t, j):
    for a, b in zip(jax.tree.leaves(params_to_numpy(t)),
                    jax.tree.leaves(jax.device_get(j))):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_forward_and_decode_match_jax(name):
    """Forward over 16 tokens, then three decode steps from a state the
    JAX block advanced (carried across), states and outputs compared."""
    arch, j_init, j_fwd, j_state, j_dec, t_fwd, t_state, t_dec = \
        BLOCKS[name]
    jcfg, cfg = _cfgs(arch)
    j_fwd, j_dec = (jax.jit(f, static_argnums=0) for f in (j_fwd, j_dec))
    jp = j_init(jcfg, jax.random.key(3))
    tp = params_from_numpy(cfg, jax.device_get(jp), "cpu")
    assert {k: str(v.dtype)[6:] for k, v in tp.items()
            if torch.is_tensor(v)} == {
        k: str(v.dtype) for k, v in jp.items() if not isinstance(v, dict)}
    rng = np.random.default_rng(7)
    B, S = 2, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jy = j_fwd(jcfg, jp, jnp.asarray(x))
    ty = t_fwd(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    jst = j_state(jcfg, B)
    for t in range(3):
        jo, jst = j_dec(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jst)
    tst = params_from_numpy(cfg, jax.device_get(jst), "cpu")
    assert jax.tree.structure(jax.tree.map(np.shape, params_to_numpy(
        t_state(cfg, B, "cpu")))) == jax.tree.structure(
        jax.tree.map(np.shape, jax.device_get(jst)))
    for t in range(3, 6):
        jo, jst = j_dec(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jst)
        to, tst = t_dec(cfg, tp, torch.from_numpy(x[:, t:t + 1]), tst)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        _close_tree(tst, jst)
