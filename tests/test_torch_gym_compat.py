"""The port's gym-style adapter (``pdecontrol_tpu_torch/envs/gym_compat.py``):
the cases of ``tests/test_gym_compat.py`` on the CPU, the exact reset, and
the rule that ``device=None`` means the GPU."""

import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs import gym_compat as jgym
from pdecontrol_tpu_torch.envs import gym_compat

KS = {"n": 16, "cfg_steps": 4, "t_max": 0.02, "transient_time": 0.5}  # 5-step episodes


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_and_episode():
    env = gym_compat.make("KuramotoSivashinskyEnv-v0", config=KS, pool_size=4, device="cpu")
    obs = env.reset(seed=0)
    assert isinstance(obs, np.ndarray) and obs.shape == (1, 16)
    assert env.max_episode_steps == 5
    assert env.scenario == env.unwrapped.scenario

    done, steps = False, 0
    while not done:
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        assert obs.shape == (1, 16)
        assert isinstance(reward, float) and np.isfinite(reward)
        assert terminated is False
        done = truncated
        steps += 1
    assert steps == 5
    assert info["step"] == 5

    # reset starts a new episode
    _, info = env.reset(return_info=True)
    assert info["step"] == 0


def test_sb3_variant_flattens():
    env = gym_compat.make("KuramotoSivashinskyEnvSB3-v0", config=KS, pool_size=4,
                          device="cpu")
    obs = env.reset(seed=1)
    assert obs.shape == (16,)
    assert env.action_space.shape == (4,)
    assert env.observation_space.shape == (16,)
    obs, r, te, tr, info = env.step(np.zeros(4, np.float32))
    assert obs.shape == (16,)


def test_unknown_env():
    with pytest.raises(KeyError):
        gym_compat.make("NopeEnv-v0", device="cpu")


def test_burgers_registered():
    env = gym_compat.make("BurgersEnv-v0", config={"n": 16, "cfg_steps": 4, "t_max": 0.02},
                          device="cpu")
    obs = env.reset(seed=2)
    obs, r, te, tr, info = env.step(env.action_space.sample())
    assert np.isfinite(r) and obs.shape == (1, 16)


def test_same_registry_and_space_as_jax():
    assert sorted(gym_compat._REGISTRY) == sorted(jgym._REGISTRY)
    ours, theirs = gym_compat.Space(-1.0, 1.0, (1, 4), seed=3), jgym.Space(-1.0, 1.0, (1, 4),
                                                                          seed=3)
    np.testing.assert_array_equal(ours.sample(), theirs.sample())
    unbounded = gym_compat.Space(-np.inf, np.inf, (2,), seed=0).sample()
    assert unbounded.dtype == np.float32 and (np.abs(unbounded) <= 1).all()


def test_exact_reset_and_seeded_reset_repeat():
    env = gym_compat.make("KuramotoSivashinskyEnv-v0", config=KS, exact_reset=True,
                          device="cpu")
    a, b = env.reset(seed=7), env.reset(seed=7)
    np.testing.assert_array_equal(a, b)
    assert env._pool is None and not np.array_equal(a, env.reset())


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gym_compat.make("BurgersEnv-v0", config={"n": 16})
