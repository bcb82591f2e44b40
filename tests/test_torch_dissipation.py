"""The dissipation reward channel through the port's loops on the CPU.

The reference quirk selects the paper's dissipation + power integrand with
``{"objective": ""}`` (``runscripts/mbpo_ks_dissipation.sh``).  A tiny
``learn()`` (the verify skill's section 3 command) and a tiny SAC baseline
run on it must show, as ``tests/test_mbrl_smoke.py::
test_mbrl_smoke_both_objectives`` pins the JAX package's:

  * the env's effective objective is dissipation, as the JAX env's is;
  * every reward written to the real replay is the period mean of
    ``env.reward_fn`` over the RK4 sub-steps from the stored state under the
    stored action's forcing, and ``env.reward_fn`` is JAX's on those states;
  * every imagined reward is ``env.reward_fn`` (JAX's) on the world model's
    physical-space state and forcing, and those are what the world replay
    stores.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs import kuramoto as jenv
from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
from pdecontrol_tpu_torch.ops.kuramoto import (
    DISSIPATION, KSOperators, ks_reward, ks_rk4_substep)
from pdecontrol_tpu_torch.sac import train as sac_train
from pdecontrol_tpu_torch.utils.logging import MetricsLogger

from .test_torch_slice import SMOKE_ARGS

ENV_CONFIG = {"n": 16, "cfg_steps": 5, "t_max": 0.04, "transient_time": 0.5,
              "objective": ""}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_env():
    cfg = {k: v for k, v in ENV_CONFIG.items() if k != "transient_time"}
    return jenv.KuramotoSivashinsky.create(dtype=jnp.float64, **cfg)


def _jax_reward(jax_env, u, phi):
    return np.asarray(jax_env.reward_fn(jnp.asarray(u.double().numpy()),
                                        jnp.asarray(phi.double().numpy())))


def _check_real_replay(env, replay, jax_env):
    """Each stored reward against the period mean of ``env.reward_fn`` from
    the stored state, and ``env.reward_fn`` against JAX's on those states."""
    assert env.effective_objective == DISSIPATION == jax_env.effective_objective
    fill = replay.fill.tolist()
    rows = [r for r, f in enumerate(fill) if f > 0]
    assert rows
    u0 = torch.cat([replay.obs_seq[r, :fill[r]] for r in rows]).double()  # [S, 1, H]
    actions = torch.cat([replay.actions[r, :fill[r]] for r in rows])
    stored = torch.cat([replay.rewards[r, :fill[r]] for r in rows]).double()
    phi = env.action_to_phi(actions).double()
    ops = KSOperators.create(env.n, env.length, torch.float64)
    u, acc = u0[:, 0], torch.zeros_like(stored)
    for _ in range(env.cfg_steps):
        acc = acc + env.reward_fn(u.to(env.dtype), phi.to(env.dtype)).double()
        u = ks_rk4_substep(ops, env.dt, u, phi)
    np.testing.assert_allclose(stored.numpy(), (acc / env.cfg_steps).numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(env.reward_fn(u0.float(), phi.float()).double().numpy(),
                               _jax_reward(jax_env, u0, phi), rtol=1e-4, atol=1e-6)
    # Not the l2control channel's values.
    l2 = -(u0[:, 0] ** 2).mean(-1)
    assert not np.allclose(stored.numpy(), l2.numpy(), rtol=1e-2)


def test_learn_on_the_dissipation_channel(tmp_path):
    args = list(SMOKE_ARGS)
    args[args.index("--env_config") + 1] = json.dumps(ENV_CONFIG)
    cfg = script.config_from_args(script.build_parser().parse_args(
        args + ["--run_dir", str(tmp_path)]))
    ctl = PDEModelBasedController(cfg, device="cpu")
    jax_env = _jax_env()
    assert ctl.world.reward_fn == ctl.env.reward_fn
    scored = []
    reward_fn = ctl.world.reward_fn

    def noted(obs, phi):
        out = reward_fn(obs, phi)
        scored.append((obs.clone(), phi.clone(), out.clone()))
        return out

    ctl.world.reward_fn = noted
    try:
        ctl.learn()
    finally:
        ctl.logger.finish()
    _check_real_replay(ctl.env, ctl.replay, jax_env)

    assert scored
    for obs, phi, out in scored:
        np.testing.assert_array_equal(
            out.numpy(), ks_reward(ctl.env.ops, obs.squeeze(-2), phi.squeeze(-2),
                                   DISSIPATION).numpy())
        np.testing.assert_allclose(out.double().numpy(), _jax_reward(jax_env, obs, phi),
                                   rtol=1e-4, atol=1e-6)
    w = ctl.world_replay
    stored = torch.cat([w.rewards[r, :f] for r, f in enumerate(w.fill.tolist())])
    assert stored.numel() and np.isin(stored.numpy(),
                                      torch.cat([o for _, _, o in scored]).numpy()).all()


def test_sac_baseline_on_the_dissipation_channel(tmp_path):
    args = sac_train.build_parser().parse_args([
        "--platform", "cpu", "--env_config", json.dumps({**ENV_CONFIG, "solver": "pallas"}),
        "--num_envs", "2", "--total_timesteps", "40", "--learning_starts", "16",
        "--batch_size", "8", "--pool_size", "8", "--chunk", "5", "--eval_freq", "20",
        "--num_eval_episodes", "2", "--run_dir", str(tmp_path)])
    trainer = sac_train.SACTrainer(args, device=torch.device("cpu"))
    logger = MetricsLogger(args.run_dir, config=vars(args))
    try:
        trainer.learn(logger)
    finally:
        logger.finish()
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["num_steps_sampled"] for r in records] == [26, 36, 46]
    assert all(np.isfinite(r["sac_qf_loss"]) for r in records)
    _check_real_replay(trainer.env, trainer.replay, _jax_env())
