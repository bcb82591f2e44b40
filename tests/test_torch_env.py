"""Port parity of the KS environment and the transform algebra against the
JAX package, on the same inputs made with numpy (reset indices injected)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs import kuramoto as jenv
from pdecontrol_tpu.envs import transforms as JT
from pdecontrol_tpu_torch.envs import kuramoto as tenv
from pdecontrol_tpu_torch.envs import transforms as TT


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(dtype, **kw):
    kw = {"n": 16, "cfg_steps": 5, **kw}
    j = jenv.KuramotoSivashinsky.create(dtype=jnp.dtype(dtype), **kw)
    t = tenv.KuramotoSivashinsky.create(dtype=getattr(torch, dtype), **kw)
    return j, t


def _close(t, j, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("objective,legacy", [
    ("dissipation", True), ("dissipation", False), ("l2control", False)])
def test_step_matches_jax(objective, legacy):
    jax_env, env = _envs("float64", objective=objective, legacy_objective=legacy)
    assert env.effective_objective == jax_env.effective_objective
    assert env.max_episode_steps == jax_env.max_episode_steps
    rng = np.random.default_rng(0)
    u = rng.uniform(-1, 1, (3, 16))
    steps = np.array([0, 5, 79], np.int32)
    action = rng.uniform(-1, 1, (3, 1, 4))
    js, jo = jax_env.step(jenv.EnvState(u=jnp.asarray(u), step=jnp.asarray(steps),
                                        key=jax.random.PRNGKey(0)), jnp.asarray(action))
    ts, to = env.step(tenv.EnvState(u=torch.as_tensor(u), step=torch.as_tensor(steps)),
                      torch.as_tensor(action))
    _close(ts.u, js.u)
    _close(to.obs, jo.obs)
    _close(to.reward, jo.reward)
    np.testing.assert_array_equal(to.truncated.numpy(), np.asarray(jo.truncated))
    np.testing.assert_array_equal(to.info["step"].numpy(), np.asarray(jo.info["step"]))
    # The reward function the world model re-scores with.
    phi = env.action_to_phi(torch.as_tensor(action))
    _close(phi, jax_env.action_to_phi(jnp.asarray(action)))
    _close(env.reward_fn(torch.as_tensor(u)[:, None], phi),
           jax_env.reward_fn(jnp.asarray(u)[:, None], jax_env.action_to_phi(jnp.asarray(action))))


@pytest.mark.parametrize("solver", ["xla", "pallas"])
def test_vec_step_autoreset_matches_jax(solver):
    """Sub-envs that hit the time limit restart from the pool at the indices
    JAX draws (recomputed from its key and injected); ``final_obs`` keeps
    the terminal observation."""
    jax_env = jenv.KuramotoSivashinsky.create(n=16, cfg_steps=5, t_max=0.02,
                                              dtype=jnp.float32)
    env = tenv.KuramotoSivashinsky.create(n=16, cfg_steps=5, t_max=0.02, solver=solver)
    n_steps = env.max_episode_steps
    rng = np.random.default_rng(1)
    pool = rng.uniform(-1, 1, (6, 16)).astype(np.float32)
    u = rng.uniform(-1, 1, (4, 16)).astype(np.float32)
    steps = np.array([0, n_steps - 1, 1, n_steps - 1], np.int32)
    key = jax.random.PRNGKey(3)
    jstate = jenv.EnvState(u=jnp.asarray(u), step=jnp.asarray(steps), key=key)
    tstate = tenv.EnvState(u=torch.as_tensor(u), step=torch.as_tensor(steps))
    resets = 0
    for _ in range(3):
        action = rng.uniform(-1, 1, (4, 1, 4)).astype(np.float32)
        idx_key, _ = jax.random.split(jstate.key)
        idx = jax.random.randint(idx_key, (4,), 0, pool.shape[0])
        jstate, jo = jax_env.vec_step(jstate, jnp.asarray(action), jnp.asarray(pool))
        tstate, to = env.vec_step(tstate, torch.as_tensor(action), torch.as_tensor(pool),
                                  reset_idx=torch.as_tensor(np.array(idx)))
        for name in ("obs", "reward"):
            _close(getattr(to, name), getattr(jo, name), 3e-5, 3e-6)
        _close(to.info["final_obs"], jo.info["final_obs"], 3e-5, 3e-6)
        np.testing.assert_array_equal(to.info["autoreset"].numpy(),
                                      np.asarray(jo.info["autoreset"]))
        np.testing.assert_array_equal(tstate.step.numpy(), np.asarray(jstate.step))
        resets += int(to.info["autoreset"].sum())
    assert resets >= 2


def test_reset_pool_runs_the_solver_transient():
    env = tenv.KuramotoSivashinsky.create(n=16, cfg_steps=5, transient_time=0.05,
                                          solver="pallas")
    assert env.transient_periods == 10
    g = torch.Generator().manual_seed(0)
    pool = tenv.make_reset_pool(env, g, 10, chains=4, decorrelate_periods=2)
    assert pool.shape == (10, 16) and torch.isfinite(pool).all()
    state = env.reset_from_pool(g, pool, (3,))
    assert state.u.shape == (3, 16) and (state.step == 0).all()


def test_create_rejects_unported_and_f64_kernel():
    """Every solver of the JAX env exists; the kernel solvers are float32."""
    assert tenv.SOLVERS == ("xla", "pallas", "pallas_packed")
    env = tenv.KuramotoSivashinsky.create(solver="pallas_packed", pallas_precision="bf16_3x")
    assert (env.solver, env.pallas_precision) == ("pallas_packed", "bf16_3x")
    with pytest.raises(ValueError, match="unknown solver"):
        tenv.KuramotoSivashinsky.create(solver="pallas_block")
    for solver in ("pallas", "pallas_packed"):
        with pytest.raises(ValueError):
            tenv.KuramotoSivashinsky.create(solver=solver, dtype=torch.float64)


def test_gaussian_forcing_matches_jax():
    j = JT.GaussianForcing.create(64, 22.0, (0.0, 0.25, 0.5, 0.75), 0.4,
                                  dtype=jnp.float64)
    t = TT.GaussianForcing.create(64, 22.0, (0.0, 0.25, 0.5, 0.75), 0.4,
                                  dtype=torch.float64)
    _close(t.matrix, j.matrix, 0, 0)
    _close(t.inv_matrix, j.inv_matrix, 0, 0)
    # The reference's 1/sqrt(2*pi*sigma) normalisation at a jet centre.
    assert abs(float(t.matrix[0, 0]) - 1.0 / np.sqrt(2 * np.pi * 0.4)) < 1e-12
    a = np.random.default_rng(2).uniform(-1, 1, (5, 1, 4))
    field = t.apply(torch.as_tensor(a))
    _close(field, j.apply(jnp.asarray(a)))
    _close(t.inverse(field), a, 1e-9, 1e-12)


def test_normalize_scale_chain_inverted_match_jax():
    rng = np.random.default_rng(3)
    batches = [rng.normal(2.0, 3.0, (b, 1, 8)) for b in (4, 5, 3)]
    jn = JT.Normalize.create((1, 1, 8), aggregate=True, batched=True, dtype=jnp.float64)
    tn = TT.Normalize.create((1, 1, 8), aggregate=True, batched=True, dtype=torch.float64)
    js = JT.Scale.create((1, 1, 8), aggregate=True, batched=True, dtype=jnp.float64)
    ts = TT.Scale.create((1, 1, 8), aggregate=True, batched=True, dtype=torch.float64)
    jc = JT.Chain(transforms=(js, jn))
    tc = TT.Chain(transforms=(ts, tn))
    ji, ti = jn.inv, tn.inv
    for x in batches:
        jx, tx = jnp.asarray(x), torch.as_tensor(x)
        jn, tn = jn.update(jx), tn.update(tx)
        js, ts = js.update(jx), ts.update(tx)
        jc, tc = jc.update(jx), tc.update(tx)
        ji, ti = ji.update(jx), ti.update(tx)
        # Welford merge at count = bsize, ddof = 1.
        _close(tn.mean, jn.mean)
        _close(tn.var, jn.var)
        _close(tn.count, jn.count)
        _close(ts.vmin, js.vmin)
        _close(ts.vmax, js.vmax)
        _close(tc.apply(tx), jc.apply(jx))
        _close(tc.inverse(tc.apply(tx)), x, 1e-9, 1e-9)
        _close(ti.base.mean, ji.base.mean)
    frozen = TT.Normalize.create((1, 1, 8), frozen=True)
    assert frozen.update(torch.ones(2, 1, 8)) is frozen
    sensor = TT.Sensor(stride=2)
    _close(sensor.apply(torch.as_tensor(batches[0])),
           JT.Sensor(stride=2).apply(jnp.asarray(batches[0])), 0, 0)
