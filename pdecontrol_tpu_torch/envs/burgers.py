"""Viscous Burgers control environment, batched (port of
``pdecontrol_tpu/envs/burgers.py``).

The numerics are those fixed by the reference's ``BurgersPhyPDELoss``
(``surrogates/phyloss/phyloss.py:36-89``): central 2nd/4th-order stencils,
Heun time stepping, a periodic domain.  Episode and actuation structure
mirror the KS environment (Gaussian jets, period-averaged reward,
truncation-only episodes), so the whole surrogate and MBRL stack applies
unchanged.  Random draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from pdecontrol_tpu_torch.envs.kuramoto import EnvState, StepOut
from pdecontrol_tpu_torch.envs.transforms import GaussianForcing
from pdecontrol_tpu_torch.ops.burgers import (
    DISSIPATION,
    L2CONTROL,
    BurgersOperators,
    burgers_control_period,
    burgers_reward,
)


@dataclasses.dataclass(frozen=True, eq=False)
class Burgers:
    """Environment definition (parameters + precomputed operators)."""

    ops: BurgersOperators
    forcing: GaussianForcing
    length: float = 16.0
    n: int = 64
    nu: float = 0.25
    cfg_steps: int = 250
    t_max: float = 100.0
    dt: float = 1e-3
    sigma: float = 0.4
    objective: str = "dissipation"
    legacy_objective: bool = True
    xi_rel: Tuple[float, ...] = (0.0, 0.25, 0.5, 0.75)
    ic_modes: int = 4

    @classmethod
    def create(
        cls,
        length: float = 16.0,
        n: int = 64,
        nu: float = 0.25,
        cfg_steps: int = 250,
        t_max: float = 100.0,
        dt: float = 1e-3,
        sigma: float = 0.4,
        objective: str = "dissipation",
        legacy_objective: bool = True,
        dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> "Burgers":
        xi_rel = (0.0, 0.25, 0.5, 0.75)
        # Zero-mean jets: central-difference Burgers has no damping of the
        # k=0 mode, so raw Gaussian jets inject unbounded mean momentum over
        # a 100-time-unit episode; momentum-conserving actuation keeps the
        # env well-posed for ANY policy.  nu=0.25 keeps the cell Reynolds
        # number u*dx/nu <= ~2 at the attained amplitudes.
        return cls(
            ops=BurgersOperators.create(n, length, nu, dtype=dtype, device=device),
            forcing=GaussianForcing.create(n, length, xi_rel, sigma, dtype=dtype,
                                           device=device, zero_mean=True),
            length=length,
            n=n,
            nu=nu,
            cfg_steps=cfg_steps,
            t_max=t_max,
            dt=dt,
            sigma=sigma,
            objective=objective,
            legacy_objective=legacy_objective,
            xi_rel=xi_rel,
        )

    # ------------------------------------------------------------------ meta
    @property
    def dtype(self) -> torch.dtype:
        return self.ops.dtype

    @property
    def device(self) -> torch.device:
        return self.ops.device

    @property
    def max_episode_steps(self) -> int:
        return math.ceil(self.t_max / (self.dt * self.cfg_steps))

    @property
    def delta(self) -> float:
        return self.cfg_steps * self.dt

    @property
    def num_jets(self) -> int:
        return len(self.xi_rel)

    @property
    def obs_shape(self) -> Tuple[int, int]:
        return (1, self.n)

    @property
    def action_shape(self) -> Tuple[int, int]:
        return (1, self.num_jets)

    @property
    def action_low(self) -> float:
        return -1.0

    @property
    def action_high(self) -> float:
        return 1.0

    @property
    def effective_objective(self) -> str:
        # As the KS env: any truthy objective string selects l2control.
        if self.legacy_objective:
            return L2CONTROL if self.objective else DISSIPATION
        return self.objective or DISSIPATION

    @property
    def scenario(self) -> Dict:
        return {
            "cfg_steps": self.cfg_steps,
            "L": self.length,
            "N": self.n,
            "dx": self.length / self.n,
            "Tmax": self.t_max,
            "dt": self.dt,
            "nu": self.nu,
            "Xi": list(self.xi_rel),
            "objective": self.objective,
        }

    # --------------------------------------------------------------- physics
    def action_to_phi(self, action: torch.Tensor) -> torch.Tensor:
        phi = self.forcing.apply(action.to(self.dtype))
        if phi.ndim >= 2 and phi.shape[-2] == 1:
            phi = phi.squeeze(-2)
        return phi

    def reward_fn(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        if u.ndim >= 2 and u.shape[-2] == 1:
            u = u.squeeze(-2)
        if phi.ndim >= 2 and phi.shape[-2] == 1:
            phi = phi.squeeze(-2)
        return burgers_reward(self.ops, u, phi.to(u.dtype), self.effective_objective)

    # ----------------------------------------------------------------- reset
    def ic_from_draws(self, amps: torch.Tensor, phases: torch.Tensor) -> torch.Tensor:
        """The initial field of ``[..., ic_modes]`` amplitudes and phases: a
        superposition of the lowest Fourier modes."""
        x = torch.linspace(0.0, self.length - self.length / self.n, self.n,
                           dtype=amps.dtype, device=amps.device)
        k = torch.arange(1, self.ic_modes + 1, dtype=amps.dtype, device=amps.device)
        waves = torch.sin(2.0 * math.pi * k[:, None] * x[None, :] / self.length
                          + phases[..., None])
        return torch.sum(amps[..., None] * waves, dim=-2).to(self.dtype)

    def sample_ic(self, generator: torch.Generator,
                  batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Random superposition of low-wavenumber Fourier modes (smooth,
        O(1)-amplitude fields on which the advective term matters)."""
        shape = tuple(batch_shape) + (self.ic_modes,)
        amps = torch.rand(shape, generator=generator, dtype=self.dtype,
                          device=self.device) * 0.5 - 0.25
        phases = torch.rand(shape, generator=generator, dtype=self.dtype,
                            device=self.device) * (2.0 * math.pi)
        return self.ic_from_draws(amps, phases)

    def _fresh(self, u: torch.Tensor, batch_shape, generator) -> EnvState:
        return EnvState(
            u=u,
            step=torch.zeros(tuple(batch_shape), dtype=torch.int32, device=self.device),
            generator=generator,
        )

    def reset(self, generator: torch.Generator,
              batch_shape: Tuple[int, ...] = ()) -> EnvState:
        return self._fresh(self.sample_ic(generator, batch_shape), batch_shape, generator)

    def reset_from_pool(self, generator: torch.Generator, pool: torch.Tensor,
                        batch_shape: Tuple[int, ...] = ()) -> EnvState:
        idx = torch.randint(0, pool.shape[0], tuple(batch_shape), generator=generator,
                            device=pool.device)
        return self._fresh(pool[idx], batch_shape, generator)

    # ------------------------------------------------------------------ step
    def observe(self, state: EnvState) -> torch.Tensor:
        return state.u[..., None, :]

    def step(self, state: EnvState, action: torch.Tensor) -> Tuple[EnvState, StepOut]:
        phi = self.action_to_phi(action)
        u, reward = burgers_control_period(
            self.ops, state.u, phi, self.dt, self.cfg_steps, self.effective_objective
        )
        step = state.step + 1
        truncated = step >= self.max_episode_steps
        state = state.replace(u=u, step=step)
        out = StepOut(
            obs=self.observe(state),
            reward=reward,
            terminated=torch.zeros_like(truncated),
            truncated=truncated,
            info={"step": step},
        )
        return state, out

    def vec_step(
        self,
        state: EnvState,
        action: torch.Tensor,
        pool: torch.Tensor,
        reset_idx: Optional[torch.Tensor] = None,
    ) -> Tuple[EnvState, StepOut]:
        """Batched step with gym-style auto-reset from ``pool`` (at
        ``reset_idx`` if given, else at indices drawn from
        ``state.generator``); the terminal observation is
        ``info["final_obs"]``."""
        state, out = self.step(state, action)
        final_obs = out.obs

        need_reset = out.truncated | out.terminated
        if reset_idx is None:
            reset_idx = torch.randint(0, pool.shape[0], need_reset.shape,
                                      generator=state.generator, device=pool.device)
        fresh_u = pool[reset_idx]

        u = torch.where(need_reset[..., None], fresh_u, state.u)
        step = torch.where(need_reset, torch.zeros_like(state.step), state.step)
        state = state.replace(u=u, step=step)

        info = dict(out.info)
        info["final_obs"] = final_obs
        info["autoreset"] = need_reset
        return state, out._replace(obs=self.observe(state), info=info)


def make_reset_pool(env: Burgers, generator: torch.Generator, pool_size: int
                    ) -> torch.Tensor:
    """Burgers ICs are cheap (no chaotic transient); sample directly."""
    return env.sample_ic(generator, (pool_size,))
