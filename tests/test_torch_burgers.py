"""Port parity of the Burgers solver, the zero-mean forcing and the Burgers
env: a control period against the numpy oracle of ``tests/oracles.py`` and
against the JAX package (float64 at 1e-9, float32 at rtol 3e-5 / atol 3e-6,
both objectives), the forcing matrix bit for bit, and the env's step,
auto-reset (on injected indices) and initial conditions (on injected draws).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs import burgers as jenv
from pdecontrol_tpu.envs import kuramoto as jks
from pdecontrol_tpu.envs import transforms as JT
from pdecontrol_tpu.ops import burgers as jops
from pdecontrol_tpu_torch.envs import burgers as tenv
from pdecontrol_tpu_torch.envs import transforms as TT
from pdecontrol_tpu_torch.envs.kuramoto import EnvState
from pdecontrol_tpu_torch.ops import burgers as tops

from .oracles import BurgersOracle

N, L, NU, DT, STEPS = 32, 16.0, 0.25, 1e-3, 20
OBJECTIVES = [tops.L2CONTROL, tops.DISSIPATION]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(seed=0, b=5):
    rng = np.random.default_rng(seed)
    x = np.arange(N) * L / N
    u = sum(rng.uniform(-0.5, 0.5, (b, 1)) * np.sin(2 * np.pi * k * x / L
                                                    + rng.uniform(0, 6.28, (b, 1)))
            for k in (1, 2, 3))
    phi = rng.uniform(-0.3, 0.3, (b, N))
    return u, phi


def _oracle_period(u, phi, objective):
    oracle = BurgersOracle(L=L, N=N, nu=NU, dt=DT)
    acc = np.zeros(u.shape[0])
    for _ in range(STEPS):
        if objective == tops.L2CONTROL:
            acc += -np.sum(u * u, -1) / N
        else:
            u_x = oracle._corr(u, oracle.D1) / oracle.dx
            u_xx = oracle._corr(u, oracle.D2) / oracle.dx**2
            acc += -(np.mean(u_xx**2, -1) + np.mean(u_x**2, -1) + np.mean(u * phi, -1))
        u = oracle.heun(u, phi)
    return u, acc / STEPS


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_control_period_float64_matches_oracle_and_jax(objective):
    u, phi = _fields()
    t_ops = tops.BurgersOperators.create(N, L, NU, dtype=torch.float64)
    j_ops = jops.BurgersOperators.create(N, L, NU, dtype=jnp.float64)
    np.testing.assert_array_equal(t_ops.deriv.numpy(), np.asarray(j_ops.deriv))
    tu, tr = tops.burgers_control_period(t_ops, torch.as_tensor(u), torch.as_tensor(phi),
                                         DT, STEPS, objective)
    ju, jr = jops.burgers_control_period(j_ops, jnp.asarray(u), jnp.asarray(phi), DT,
                                         STEPS, objective)
    ou, orw = _oracle_period(u, phi, objective)
    assert tu.dtype == torch.float64 and tr.shape == (5,)
    for got, jax_, ora in ((tu, ju, ou), (tr, jr, orw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got.numpy(), ora, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_control_period_float32_matches_jax(objective):
    u, phi = _fields(seed=1)
    u32, phi32 = u.astype(np.float32), phi.astype(np.float32)
    t_ops = tops.BurgersOperators.create(N, L, NU)
    j_ops = jops.BurgersOperators.create(N, L, NU)
    assert t_ops.dtype == torch.float32
    tu, tr = tops.burgers_control_period(t_ops, torch.as_tensor(u32), torch.as_tensor(phi32),
                                         DT, STEPS, objective)
    ju, jr = jops.burgers_control_period(j_ops, jnp.asarray(u32), jnp.asarray(phi32), DT,
                                         STEPS, objective)
    assert tu.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=3e-5, atol=3e-6)


def test_rhs_substep_and_reward_match_jax_on_any_leading_shape():
    rng = np.random.default_rng(2)
    u, phi = rng.normal(size=(2, 3, N)), rng.normal(size=(2, 3, N))
    t_ops = tops.BurgersOperators.create(N, L, NU, dtype=torch.float64)
    j_ops = jops.BurgersOperators.create(N, L, NU, dtype=jnp.float64)
    tu, tp, ju, jp = torch.as_tensor(u), torch.as_tensor(phi), jnp.asarray(u), jnp.asarray(phi)
    for t, j in zip(tops.burgers_derivatives(t_ops, tu), jops.burgers_derivatives(j_ops, ju)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tops.burgers_rhs(t_ops, tu, tp).numpy(),
                               np.asarray(jops.burgers_rhs(j_ops, ju, jp)), rtol=1e-9)
    np.testing.assert_allclose(tops.burgers_heun_substep(t_ops, DT, tu, tp).numpy(),
                               np.asarray(jops.burgers_heun_substep(j_ops, DT, ju, jp)),
                               rtol=1e-9)
    for objective in OBJECTIVES:
        np.testing.assert_allclose(
            tops.burgers_reward(t_ops, tu, tp, objective).numpy(),
            np.asarray(jops.burgers_reward(j_ops, ju, jp, objective)), rtol=1e-9)
    with pytest.raises(ValueError, match="unknown objective"):
        tops.burgers_reward(t_ops, tu, tp, "nope")


@pytest.mark.parametrize("zero_mean", [True, False])
def test_gaussian_forcing_matches_jax_bit_for_bit(zero_mean):
    xi = (0.0, 0.25, 0.5, 0.75)
    tf = TT.GaussianForcing.create(N, L, xi, 0.4, dtype=torch.float64, zero_mean=zero_mean)
    jf = JT.GaussianForcing.create(N, L, xi, 0.4, dtype=jnp.float64, zero_mean=zero_mean)
    np.testing.assert_array_equal(tf.matrix.numpy(), np.asarray(jf.matrix))
    np.testing.assert_array_equal(tf.inv_matrix.numpy(), np.asarray(jf.inv_matrix))
    np.testing.assert_array_equal(tf.jet_idx.numpy(), np.asarray(jf.jet_idx))
    means = tf.matrix.mean(dim=1).abs().max()
    assert (means < 1e-15) == zero_mean
    a = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (4, 1, 4)))
    np.testing.assert_allclose(tf.inverse(tf.apply(a)).numpy(), a.numpy(), atol=1e-12)


def _envs(**kw):
    cfg = dict(n=N, cfg_steps=5, t_max=0.02, **kw)  # 4-step episodes
    return (tenv.Burgers.create(**cfg, dtype=torch.float64),
            jenv.Burgers.create(**cfg, dtype=jnp.float64))


@pytest.mark.parametrize("objective, legacy", [("dissipation", True), ("", True),
                                               ("dissipation", False), ("l2control", False),
                                               ("", False)])
def test_env_step_scenario_and_objective_match_jax(objective, legacy):
    te, je = _envs(objective=objective, legacy_objective=legacy)
    assert te.effective_objective == je.effective_objective
    assert te.scenario == je.scenario and {"dx", "nu"} <= set(te.scenario)
    assert (te.max_episode_steps, te.delta, te.obs_shape, te.action_shape, te.num_jets) == (
        je.max_episode_steps, je.delta, je.obs_shape, je.action_shape, je.num_jets)
    assert (te.action_low, te.action_high) == (je.action_low, je.action_high)
    rng = np.random.default_rng(4)
    u = rng.uniform(-0.5, 0.5, (3, N))
    a = rng.uniform(-1, 1, (3, 1, 4))
    import jax

    ts, tout = te.step(EnvState(u=torch.as_tensor(u), step=torch.zeros(3, dtype=torch.int32)),
                       torch.as_tensor(a))
    js, jout = je.step(jks.EnvState(u=jnp.asarray(u), step=jnp.zeros(3, jnp.int32),
                                    key=jax.random.PRNGKey(0)), jnp.asarray(a))
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), rtol=1e-9)
    np.testing.assert_array_equal(tout.info["step"].numpy(), np.asarray(jout.info["step"]))
    assert tout.obs.shape == (3, 1, N) and not tout.truncated.any()
    np.testing.assert_allclose(
        te.reward_fn(tout.obs, te.action_to_phi(torch.as_tensor(a))[:, None]).numpy(),
        np.asarray(je.reward_fn(jout.obs, je.action_to_phi(jnp.asarray(a))[:, None])),
        rtol=1e-9)


def test_vec_step_autoresets_on_injected_indices():
    te, je = _envs()
    rng = np.random.default_rng(5)
    pool = rng.uniform(-0.5, 0.5, (6, N))
    u = rng.uniform(-0.5, 0.5, (3, N))
    a = rng.uniform(-1, 1, (3, 1, 4))
    # Env 1 is one step before the time limit (4 steps): it truncates.
    steps = np.array([0, 3, 1], np.int32)
    idx = np.array([5, 2, 0])
    state = EnvState(u=torch.as_tensor(u), step=torch.as_tensor(steps))
    new, out = te.vec_step(state, torch.as_tensor(a), torch.as_tensor(pool),
                           reset_idx=torch.as_tensor(idx))
    _, plain = te.step(state, torch.as_tensor(a))
    np.testing.assert_array_equal(out.truncated.numpy(), [False, True, False])
    np.testing.assert_array_equal(out.info["autoreset"].numpy(), [False, True, False])
    np.testing.assert_array_equal(new.step.numpy(), [1, 0, 2])
    np.testing.assert_array_equal(out.info["step"].numpy(), [1, 4, 2])
    np.testing.assert_array_equal(out.info["final_obs"].numpy(), plain.obs.numpy())
    np.testing.assert_array_equal(new.u[1].numpy(), pool[2])
    np.testing.assert_array_equal(new.u[[0, 2]].numpy(), plain.obs[[0, 2], 0].numpy())
    np.testing.assert_array_equal(out.obs[:, 0].numpy(), new.u.numpy())
    # Without injected indices they come from the state's generator.
    gen = torch.Generator().manual_seed(0)
    drawn, _ = te.vec_step(state.replace(generator=gen), torch.as_tensor(a),
                           torch.as_tensor(pool))
    assert any(np.array_equal(drawn.u[1].numpy(), row) for row in pool)


def test_initial_conditions_on_injected_draws_and_from_the_generator():
    te, je = _envs()
    rng = np.random.default_rng(6)
    amps = rng.uniform(-0.25, 0.25, (7, 4))
    phases = rng.uniform(0, 2 * np.pi, (7, 4))
    # The JAX env's formula (envs/burgers.py:166-173) on the same draws.
    x = np.linspace(0.0, L - L / N, N)
    k = np.arange(1, 5)
    waves = np.sin(2 * np.pi * k[:, None] * x[None, :] / L + phases[..., None])
    expect = np.sum(amps[..., None] * waves, axis=-2)
    got = te.ic_from_draws(torch.as_tensor(amps), torch.as_tensor(phases))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-9, atol=1e-12)

    gen = torch.Generator().manual_seed(1)
    pool = tenv.make_reset_pool(te, gen, 200)
    assert pool.shape == (200, N) and pool.dtype == torch.float64
    assert float(pool.abs().max()) <= 1.0  # 4 modes of amplitude <= 0.25
    assert abs(float(pool.mean())) < 0.02 and 0.1 < float(pool.std()) < 0.35
    state = te.reset_from_pool(gen, pool, (5,))
    assert state.u.shape == (5, N) and state.generator is gen
    assert all(any(torch.equal(row, p) for p in pool) for row in state.u)
    assert not state.step.any() and state.step.dtype == torch.int32
    fresh = te.reset(gen, (2,))
    assert fresh.u.shape == (2, N) and te.observe(fresh).shape == (2, 1, N)
    assert te.reset(gen).u.shape == (N,)
