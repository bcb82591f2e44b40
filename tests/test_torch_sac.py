"""Port parity of SAC: updates on fixed float32 batches against the JAX
package, with the networks carried over by ``pdecontrol_tpu_torch.convert``
and the two normal draws of each JAX update (the split at sac.py:122)
recomputed and handed to the port as ``noise``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.data.types import Sample as JSample
from pdecontrol_tpu.sac import nets as jnets
from pdecontrol_tpu.sac.sac import SAC as JSAC
from pdecontrol_tpu.sac.sac import SACConfig as JConfig
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.data.types import Sample
from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig

OBS, ACT = (1, 16), (1, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, b=32):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        obs=rng.normal(size=(b,) + OBS).astype(f),
        actions=rng.uniform(-1, 1, (b,) + ACT).astype(f),
        nxtobs=rng.normal(size=(b,) + OBS).astype(f),
        rewards=rng.normal(size=(b,)).astype(f),
        terminated=rng.uniform(size=b) < 0.25,
        truncated=np.zeros(b, bool),
        steps=np.zeros(b, np.int32),
    )


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


def _check_nets(tstate, jstate, tol):
    for module, params in ((tstate.policy, jstate.policy_params),
                           (tstate.critic, jstate.critic_params),
                           (tstate.target, jstate.target_params)):
        expect = convert.state_dict(jax.tree.map(np.asarray, params))
        got = module.state_dict()
        assert set(got) == set(expect)
        for name, value in expect.items():
            _close(got[name], value.numpy(), tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(automatic_entropy_tuning=True, reward_scale=2.0, target_update_interval=2),
])
def test_updates_match_jax(kw, dtype):
    """Two chained updates.  In float64 everything agrees to 1e-9: the
    algorithm is the same.  In float32 the parameters agree to 1e-5 and the
    losses to 1e-4 (measured gaps: losses up to 4e-5, parameters up to
    4e-6): every loss reads a log-probability (the critic target through
    ``next_log_pi``), and the squash correction log(1 - tanh^2 + 1e-6) turns
    a one-ulp difference in a saturated action (from another summation
    order in a matmul, or XLA's float32 tanh, ~4 ulp off) into a large
    relative change of that term; the gap stays when the JAX side's tanh is
    rounded correctly.  An early Adam step is about lr * sign(g), so a
    gradient element near zero that rounds the other way moves its
    parameter by a few 1e-6."""
    tol = 1e-5 if dtype == "float32" else 1e-9
    jagent = JSAC(OBS, ACT, JConfig(hidden=32, **kw))
    jstate = jagent.init(jax.random.PRNGKey(0))
    agent = SAC(OBS, ACT, SACConfig(hidden=32, **kw))
    assert agent.config == jagent.config._replace()
    # The whole JAX state in ``dtype`` (under the suite's x64 its log_alpha
    # would otherwise be float64 and pull the critic target into float64).
    p, c = (jax.tree.map(lambda x: x.astype(dtype), t)
            for t in (jstate.policy_params, jstate.critic_params))
    log_alpha = jnp.zeros((), dtype)
    jstate = jstate.replace(
        policy_params=p, critic_params=c, target_params=c,
        policy_opt=jagent.optimizer.init(p), critic_opt=jagent.optimizer.init(c),
        log_alpha=log_alpha, alpha_opt=jagent.optimizer.init(log_alpha))
    state = agent.init(dtype=getattr(torch, dtype))
    for module, params in ((state.policy, jstate.policy_params),
                           (state.critic, jstate.critic_params),
                           (state.target, jstate.target_params)):
        module.load_state_dict(convert.state_dict(jax.tree.map(np.asarray, params)))

    update = jax.jit(jagent.update)
    for i in range(2):
        data = {k: v.astype(dtype) if v.dtype == np.float32 else v
                for k, v in _batch(i).items()}
        key = jax.random.PRNGKey(10 + i)
        knext, kpi = jax.random.split(key)
        noise = tuple(torch.tensor(np.asarray(
            jax.random.normal(k, (32,) + ACT, jnp.dtype(dtype)))) for k in (knext, kpi))
        jstate, jm = update(jstate, JSample(**{k: jnp.asarray(v) for k, v in data.items()}),
                            key)
        state, tm = agent.update(state, Sample(**{k: torch.as_tensor(v)
                                                  for k, v in data.items()}), noise=noise)
        _close(tm["reward_mean"], jm["reward_mean"], tol)
        for name in ("qf_loss", "qf1_loss", "qf2_loss", "policy_loss", "alpha_loss"):
            _close(tm[name], jm[name], 1e-4 if dtype == "float32" else tol)
        _check_nets(state, jstate, tol)
        _close(state.log_alpha, jstate.log_alpha, tol)
    assert state.updates == int(jstate.updates) == 2


def test_policy_sample_and_select_action_match_jax():
    policy = jnets.GaussianPolicy(achannels=1, asize=4, hidden=32)
    obs = np.random.default_rng(3).normal(size=(5,) + OBS).astype(np.float32)
    params = policy.init(jax.random.PRNGKey(4), jnp.asarray(obs))["params"]
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (5,) + ACT, jnp.float32))
    ja, jlp, jdet = policy.apply({"params": params}, jnp.asarray(obs), key,
                                 method=jnets.GaussianPolicy.sample)
    agent = SAC(OBS, ACT, SACConfig(hidden=32))
    state = agent.init()
    state.policy.load_state_dict(convert.state_dict(jax.tree.map(np.asarray, params)))
    ta, tlp, tdet = state.policy.sample(torch.as_tensor(obs), noise=torch.as_tensor(noise))
    _close(ta, ja, 1e-6)
    _close(tlp, jlp, 1e-4)  # the squash correction, see test_updates_match_jax
    _close(tdet, jdet, 1e-6)
    det = agent.select_action(state, torch.as_tensor(obs), deterministic=True)
    _close(det, jdet, 1e-6)
    # The log-std clamp of the reference (policies.py:112-125).
    _, log_std = state.policy(torch.as_tensor(obs) * 1e4)
    assert float(log_std.detach().min()) >= -20.0 and float(log_std.detach().max()) <= 2.0
