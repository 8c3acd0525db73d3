"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

Reduced olmoe-1b-7b (4 experts, top-2) and reduced deepseek-moe-16b (one
shared expert), fp32 compute: the same numpy weights (JAX's ``init_moe``,
carried over by ``params_from_numpy``) and the same numpy input through
both.  Compared at atol = rtol = 1e-5: the output, the three aux values
and the gradient of a scalar of the output and the aux losses with
respect to every parameter and the input.  The capacity is set so that
one case must drop tokens (32 slots for 16 places) and one cannot
(C = T); the third keeps the config's factor of 1.25.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.config import get_arch as j_get_arch
from repro.models import moe as JM

from repro_torch.config import get_arch
from repro_torch.models import moe as TM
from repro_torch.models.registry import params_from_numpy
from repro_torch.optim.adamw import tree_leaves

from _torch_port import (  # noqa: F401  (the fixtures: autouse)
    fresh_jax_caches,
)
pytest_plugins = ("_jax_maps",)   # keeps every test under the map limit

TOL = dict(atol=1e-5, rtol=1e-5)
AUX = ("moe_balance", "moe_z", "moe_dropped")
# capacity factor -> C = int(T K / E * factor) at T = 16, K = 2, E = 4
CASES = {"drops": 0.5, "default": 1.25, "fits": 2.0}


def _cfgs(arch, factor):
    jcfg, cfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=factor))
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_moe_16b"])
def test_moe_fwd_and_grads_match_jax(arch, case):
    jcfg, cfg = _cfgs(arch, CASES[case])
    jp = JM.init_moe(jcfg, jax.random.key(7))
    hp = jax.device_get(jp)
    tp = params_from_numpy(cfg, hp, "cpu")
    assert set(tp) == set(hp) and ("shared" in tp) == bool(cfg.moe.n_shared)
    rng = np.random.default_rng(11)
    B, S, D = 2, 8, cfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((B, S, D)).astype(np.float32)

    def jloss(p, x):
        out, aux = JM.moe_fwd(jcfg, p, x)
        return jnp.sum(out * w) + aux["moe_balance"] + aux["moe_z"], \
            (out, aux)
    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.tensor(x, requires_grad=True)
    out, aux = TM.moe_fwd(cfg, tp, tx)
    loss = (out * torch.tensor(w)).sum() + aux["moe_balance"] + aux["moe_z"]
    grads = torch.autograd.grad(loss, leaves + [tx])

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for k in AUX:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   **TOL)
    C = max(1, int(B * S * cfg.moe.top_k / cfg.moe.n_experts
                   * cfg.moe.capacity_factor))
    if case == "drops":
        assert C == 4 and float(aux["moe_dropped"]) > 0
    if case == "fits":
        assert C == B * S and float(aux["moe_dropped"]) == 0
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgp)] + [
        np.asarray(jgx)]
    assert len(jleaves) == len(grads)
    for g, j in zip(grads, jleaves):
        assert g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), j, **TOL)


def test_moe_combine_is_a_fixed_order_gather():
    """Two calls give bit-identical outputs and gradients, and each
    dropped (token, choice) contributes nothing: with C = 1 only the first
    token of each expert's segment reaches it."""
    _, cfg = _cfgs("olmoe_1b_7b", 0.1)
    p = TM.init_moe(cfg, torch.Generator().manual_seed(2))
    assert p["router"].dtype == torch.float32
    assert p["w1"].shape == (4, cfg.d_model, 32) and p["w2"].shape == (
        4, 32, cfg.d_model)
    x = torch.randn(1, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))

    def run():
        xi = x.clone().requires_grad_(True)
        out, aux = TM.moe_fwd(cfg, p, xi)
        (gx,) = torch.autograd.grad(out.square().sum(), xi)
        return out.detach(), gx, aux
    (o1, g1, aux), (o2, g2, _) = run(), run()
    assert torch.equal(o1, o2) and torch.equal(g1, g2)
    # 12 slots, 4 experts of capacity 1
    assert float(aux["moe_dropped"]) == pytest.approx(1 - 4 / 12)
    _, _, gate, choice = TM.route(cfg, p, x[0])
    want = torch.zeros_like(x[0])
    seen = set()
    for t in range(6):
        for j in range(cfg.moe.top_k):
            e = int(choice[t, j])
            if e in seen:
                continue
            seen.add(e)
            xe = x[0, t]
            h = torch.nn.functional.silu(xe @ p["w1"][e]) * (xe @ p["w3"][e])
            want[t] += gate[t, j] * (h @ p["w2"][e])
    np.testing.assert_allclose(o1[0].numpy(), want.numpy(), atol=1e-6)
