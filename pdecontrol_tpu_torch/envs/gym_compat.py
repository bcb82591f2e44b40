"""Gym-style stateful adapter over the functional envs (port of
``pdecontrol_tpu/envs/gym_compat.py``).

The reference exposes its environments through the gym registry
(``pdegym/kuramoto/__init__.py:26-37``: ``KuramotoSivashinskyEnv-v0`` plus
an SB3 variant with flattened spaces).  This module provides the equivalent
imperative interface — ``make(env_id)`` returning an object with
``reset()``/``step(action)`` in the new (5-tuple) gym step API — for users
migrating hand-written loops or third-party agents.  The adapter just
carries the state; observations and rewards come back as numpy values.
``device=None`` means the GPU, as for every entry point of the port, and
raises without one; ``device="cpu"`` asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pdecontrol_tpu_torch.utils.device import entry_device

_REGISTRY: Dict[str, Any] = {}


class Space:
    """Minimal Box-like space."""

    def __init__(self, low, high, shape, seed: int = 0):
        self.low, self.high, self.shape = low, high, tuple(shape)
        self._rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        lo = self.low if np.ndim(self.low) else np.full(self.shape, self.low)
        hi = self.high if np.ndim(self.high) else np.full(self.shape, self.high)
        lo = np.nan_to_num(lo, neginf=-1.0)
        hi = np.nan_to_num(hi, posinf=1.0)
        return self._rng.uniform(lo, hi, size=self.shape).astype(np.float32)


class GymEnv:
    """Stateful single-env adapter (new gym step API: 5-tuple).
    ``make_pool`` is the env module's ``make_reset_pool``."""

    def __init__(self, env, make_pool, flatten: bool = False, exact_reset: bool = False,
                 pool_size: int = 64, seed: int = 0):
        self.env = env
        self._make_pool = make_pool
        self.flatten = flatten
        self.exact_reset = exact_reset
        self._gen = torch.Generator(device=env.device).manual_seed(seed)
        self._state = None
        self._pool = None
        self._pool_size = pool_size

        oshape = env.obs_shape[1:] if flatten else env.obs_shape
        ashape = env.action_shape[1:] if flatten else env.action_shape
        self.observation_space = Space(-np.inf, np.inf, oshape, seed)
        self.action_space = Space(env.action_low, env.action_high, ashape, seed)

    @property
    def unwrapped(self):
        return self.env

    @property
    def scenario(self):
        return self.env.scenario

    @property
    def max_episode_steps(self) -> int:
        return self.env.max_episode_steps

    def _obs(self, obs: torch.Tensor) -> np.ndarray:
        obs = obs.cpu().numpy()
        return obs[0] if self.flatten else obs

    @torch.no_grad()
    def reset(self, seed: Optional[int] = None, return_info: bool = False):
        if seed is not None:
            self._gen.manual_seed(seed)
        if self.exact_reset:
            self._state = self.env.reset(self._gen)
        else:
            if self._pool is None:
                self._pool = self._make_pool(self.env, self._gen, self._pool_size)
            self._state = self.env.reset_from_pool(self._gen, self._pool)
        obs = self._obs(self.env.observe(self._state))
        if return_info:
            return obs, {"step": 0}
        return obs

    @torch.no_grad()
    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        action = torch.as_tensor(np.asarray(action, np.float32), device=self.env.device)
        if self.flatten:
            action = action[None]
        self._state, out = self.env.step(self._state, action)
        info = {"step": int(out.info["step"])}
        return (
            self._obs(out.obs),
            float(out.reward),
            bool(out.terminated),
            bool(out.truncated),
            info,
        )


def register(env_id: str, make_env) -> None:
    _REGISTRY[env_id] = make_env


def make(env_id: str, config: Optional[Dict] = None, device=None, **kwargs) -> GymEnv:
    """Reference ``pdegym.kuramoto.make`` equivalent (TimeLimit semantics are
    native to the functional env's truncation counter)."""
    if env_id not in _REGISTRY:
        raise KeyError(f"unknown env {env_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[env_id](config or {}, entry_device(device), **kwargs)


def _build_ks(config, device, **kwargs):
    from pdecontrol_tpu_torch.envs.kuramoto import KuramotoSivashinsky, make_reset_pool

    env = KuramotoSivashinsky.create(**config, device=device)
    return GymEnv(env, make_reset_pool, **kwargs)


def _build_ks_sb3(config, device, **kwargs):
    # SB3 variant: flattened obs/action spaces (pdegym/kuramoto/__init__.py:15-23).
    return _build_ks(config, device, flatten=True, **kwargs)


def _build_burgers(config, device, **kwargs):
    from pdecontrol_tpu_torch.envs.burgers import Burgers, make_reset_pool

    return GymEnv(Burgers.create(**config, device=device), make_reset_pool, **kwargs)


register("KuramotoSivashinskyEnv-v0", _build_ks)
register("KuramotoSivashinskyEnvSB3-v0", _build_ks_sb3)
register("BurgersEnv-v0", _build_burgers)
