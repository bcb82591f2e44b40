"""Port parity of the surrogate metric battery: every key, shape and value
against the JAX package on one batch, for the KS and the Burgers env and an
AUTOREG and a LATENT family (float64, 1e-9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.data.types import Sample as JSample
from pdecontrol_tpu.envs import transforms as JT
from pdecontrol_tpu.envs.burgers import Burgers as JBurgers
from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky as JKS
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.train.metrics import surrogate_metric_battery as j_battery
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.data.types import Sample
from pdecontrol_tpu_torch.envs import transforms as TT
from pdecontrol_tpu_torch.envs.burgers import Burgers
from pdecontrol_tpu_torch.envs.kuramoto import KuramotoSivashinsky
from pdecontrol_tpu_torch.models import factories as TF
from pdecontrol_tpu_torch.train.metrics import surrogate_metric_battery

N, B, T, TAU = 16, 3, 7, 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("env_name, factory", [
    ("ks", "KSAutoRegConvolutionalLSTM"), ("ks", "KSLatentLSTM"),
    ("burgers", "KSAutoRegConvolutionalLSTM"), ("burgers", "KSDelayCNNSurrogateFactory")])
def test_battery_matches_jax(env_name, factory):
    rng = np.random.default_rng(0)
    if env_name == "ks":
        je = JKS.create(n=N, cfg_steps=5, dtype=jnp.float64)
        te = KuramotoSivashinsky.create(n=N, cfg_steps=5, dtype=torch.float64)
        derivs = 3
    else:
        je = JBurgers.create(n=N, cfg_steps=5, dtype=jnp.float64)
        te = Burgers.create(n=N, cfg_steps=5, dtype=torch.float64)
        derivs = 2
    raw_obs = rng.normal(0.2, 1.5, (B, T, 1, N))
    raw_act = rng.uniform(-1, 1, (B, T, 1, 4))
    seen = raw_obs.reshape(-1, 1, N)

    # Obs standardisation and forcing + field standardisation, as evaluate.py.
    jos = JT.Normalize.create(seen.shape, aggregate=True, batched=True,
                              dtype=jnp.float64).update(jnp.asarray(seen))
    tos = TT.Normalize.create(seen.shape, aggregate=True, batched=True,
                              dtype=torch.float64).update(torch.as_tensor(seen))
    jfields = je.forcing.apply(jnp.asarray(raw_act.reshape(-1, 1, 4)))
    tfields = te.forcing.apply(torch.as_tensor(raw_act.reshape(-1, 1, 4)))
    jps = JT.Normalize.create(jfields.shape, aggregate=True, batched=True,
                              dtype=jnp.float64).update(jfields)
    tps = TT.Normalize.create(tfields.shape, aggregate=True, batched=True,
                              dtype=torch.float64).update(tfields)
    jst = JT.SampleTransform(otransf=jos, atransf=JT.Chain(transforms=(je.forcing, jps)))
    tst = TT.SampleTransform(otransf=tos, atransf=TT.Chain(transforms=(te.forcing, tps)))
    und_data = rng.normal(0.1, 1.2, (5, 1, N))
    jund = JT.Normalize.create((1, 1, N), aggregate=True, batched=True,
                               dtype=jnp.float64).update(jnp.asarray(und_data))
    tund = TT.Normalize.create((1, 1, N), aggregate=True, batched=True,
                               dtype=torch.float64).update(torch.as_tensor(und_data))

    jm = JF.make(factory, delta=je.delta, N=N)
    x = jnp.zeros((1, 2, 1, N))
    params = jax.tree.map(lambda p: np.asarray(p, np.float64),
                          jax.jit(jm.init)(jax.random.PRNGKey(0), x, x)["params"])
    tm = TF.make(factory, delta=te.delta, N=N).double()
    tm.load_state_dict(convert.state_dict(params), strict=True)

    jbatch = jst(JSample(obs=jnp.asarray(raw_obs), actions=jnp.asarray(raw_act),
                         nxtobs=jnp.asarray(raw_obs)))
    tbatch = tst(Sample(obs=torch.as_tensor(raw_obs), actions=torch.as_tensor(raw_act),
                        nxtobs=torch.as_tensor(raw_obs)))
    want = jax.jit(lambda p, b: j_battery(jm, p, b, jst, jund, je, TAU))(params, jbatch)
    got = surrogate_metric_battery(tm, tbatch, tst, tund, te, TAU)

    assert set(got) == set(want)
    assert sum(k.startswith("l2_loss_derivs-derivative-") for k in got) == derivs
    for key, w in want.items():
        assert tuple(got[key].shape) == tuple(w.shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w), rtol=1e-9, atol=1e-11,
                                   err_msg=key)
    assert got["MSE"].shape == () and got["l2_loss"].shape == (T,)
    assert got["nrmse_rews"].shape == (T,) and got["states"].shape == (B, T, 1, N)
    assert got["actions"].shape == (B, T, 1, 4)
    np.testing.assert_allclose(got["actions"].numpy(), raw_act, atol=1e-9)
