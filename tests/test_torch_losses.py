"""Port parity of the training losses: ``MSELoss`` and the two physics
losses elementwise against the JAX package (float64, 1e-9), and
``make_loss``'s name resolution, ``PhyPDELoss`` dispatch and keyword
filtering."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs.burgers import Burgers as JBurgers
from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky as JKS
from pdecontrol_tpu.train import losses as JL
from pdecontrol_tpu_torch.envs.burgers import Burgers
from pdecontrol_tpu_torch.envs.kuramoto import KuramotoSivashinsky
from pdecontrol_tpu_torch.train import losses as TL

N = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenarios():
    ks = KuramotoSivashinsky.create(n=N, cfg_steps=5).scenario
    bu = Burgers.create(n=N, cfg_steps=5).scenario
    assert ks == JKS.create(n=N, cfg_steps=5).scenario
    assert bu == JBurgers.create(n=N, cfg_steps=5).scenario
    return ks, bu


@pytest.mark.parametrize("name", ["MSELoss", "KSPhyPDELoss", "BurgersPhyPDELoss"])
def test_loss_matches_jax_elementwise(name):
    ks, bu = _scenarios()
    scenario = bu if name.startswith("Burgers") else ks
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(3, 6, 1, N))
    target = rng.normal(size=(3, 6, 1, N))
    tl, jl = TL.make_loss(name, scenario), JL.make_loss(name, scenario)
    got = tl(torch.as_tensor(pred), torch.as_tensor(target))
    want = jl(jnp.asarray(pred), jnp.asarray(target))
    assert got.shape == (3, 6, 1, N) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    if name != "MSELoss":
        # A physics loss reads only its first argument.
        np.testing.assert_array_equal(tl(torch.as_tensor(pred)).numpy(), got.numpy())
        np.testing.assert_allclose(tl.phyevolve(torch.as_tensor(pred)).numpy(),
                                   np.asarray(jl.phyevolve(jnp.asarray(pred))),
                                   rtol=1e-9, atol=1e-12)


def test_physics_loss_follows_the_input_dtype_and_has_gradients():
    ks, _ = _scenarios()
    loss = TL.make_loss("KSPhyPDELoss", ks)
    x = torch.randn(2, 4, 1, N, requires_grad=True)
    out = loss(x, None)
    assert out.dtype == torch.float32
    out.mean().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert loss(x.detach().double(), None).dtype == torch.float64


def test_make_loss_dispatch_and_keyword_filtering():
    ks, bu = _scenarios()
    assert isinstance(TL.make_loss("PhyPDELoss", ks), TL.KSPhyPDELoss)
    burgers = TL.make_loss("PhyPDELoss", bu)
    assert isinstance(burgers, TL.BurgersPhyPDELoss)
    assert (burgers.dx, burgers.nu, burgers.dt) == (bu["dx"], bu["nu"], bu["dt"])
    assert burgers.ops.n == N and burgers.ops.dx == pytest.approx(bu["dx"])
    kspl = TL.make_loss("KSPhyPDELoss", {**ks, "unused": 1})
    assert kspl.dt == ks["dt"] and kspl.ops.n == N
    assert TL.make_loss("MSELoss", ks) is TL.mse_loss
    assert sorted(TL.REGISTRY) == sorted(JL.REGISTRY)
    with pytest.raises(KeyError, match="unknown loss"):
        TL.make_loss("NoSuchLoss", ks)
    with pytest.raises(NotImplementedError):
        TL.PhyPDELoss(0.1)(torch.zeros(1, 2, 1, N))
