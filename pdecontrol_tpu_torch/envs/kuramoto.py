"""Kuramoto–Sivashinsky control environment, batched (port of
``pdecontrol_tpu/envs/kuramoto.py``).

Functions over explicit state: ``step(state, action) -> (state, StepOut)``;
the batch axis is the vectorisation.  Reference semantics kept
(pdegym ``kuramoto/kuramoto.py``):

  * grid ``N=64`` on ``L=22`` periodic, ``dt=1e-3``, 250 RK4 sub-steps per
    agent step, 400 agent steps per episode (kuramoto.py:29-57);
  * 4 Gaussian jets at ``[0, .25, .5, .75]`` with ``sigma=0.4``;
  * reward = per-sub-step objective averaged over the control period, with
    the objective-selection quirk behind ``legacy_objective``
    (kuramoto.py:72): any non-empty objective string selects l2control;
  * reset = ``u ~ U(-0.4, 0.4)`` and a 200-time-unit no-op transient,
    amortised through a pool of on-attractor states (``make_reset_pool``);
  * truncation-only episodes (kuramoto.py:98).

``solver`` picks the control-period backend: ``"xla"`` is the plain path
(``ops.kuramoto.ks_control_period``), ``"pallas"`` the CUDA kernel K1
(``ops.pallas_ks``) and ``"pallas_packed"`` the bf16-limb kernel K2
(``ops.pallas_ks_packed``) at ``pallas_precision``; each kernel runs its
plain version for CPU tensors.  As in the JAX env, an odd flat batch under
``"pallas_packed"`` goes to K1 in float32, and the reset transient runs
through K1 under both kernel solvers.  The JAX env's ``pallas_block`` and
``pallas_interpret`` knobs (TPU tiling, Pallas interpret mode) have no
counterpart.  Random draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from pdecontrol_tpu_torch.envs.transforms import GaussianForcing
from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed
from pdecontrol_tpu_torch.ops.kuramoto import (
    DISSIPATION,
    L2CONTROL,
    KSOperators,
    ks_control_period,
    ks_reward,
    ks_transient,
)

SOLVERS = ("xla", "pallas", "pallas_packed")


@dataclasses.dataclass
class EnvState:
    """Per-environment simulator state; fields have a leading batch shape."""

    u: torch.Tensor  # [..., N] physical field
    step: torch.Tensor  # [...] int32 agent-step counter within the episode
    generator: Optional[torch.Generator] = None  # drives auto-resets

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


class StepOut(NamedTuple):
    obs: torch.Tensor  # [..., C=1, N]
    reward: torch.Tensor  # [...]
    terminated: torch.Tensor  # [...] bool (always False for KS)
    truncated: torch.Tensor  # [...] bool
    info: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class KuramotoSivashinsky:
    """Environment definition (parameters + precomputed operators)."""

    ops: KSOperators
    forcing: GaussianForcing
    length: float = 22.0
    n: int = 64
    cfg_steps: int = 250
    t_trans: float = 40.0
    t_max: float = 100.0
    dt: float = 1e-3
    noise: float = 0.1
    sigma: float = 0.4
    lmbda: float = 0.0
    objective: str = "dissipation"
    legacy_objective: bool = True
    xi_rel: Tuple[float, ...] = (0.0, 0.25, 0.5, 0.75)
    transient_time: float = 200.0
    solver: str = "xla"
    pallas_precision: str = "highest"

    @classmethod
    def create(
        cls,
        length: float = 22.0,
        n: int = 64,
        cfg_steps: int = 250,
        t_trans: float = 40.0,
        t_max: float = 100.0,
        dt: float = 1e-3,
        noise: float = 0.1,
        sigma: float = 0.4,
        lmbda: float = 0.0,
        objective: str = "dissipation",
        legacy_objective: bool = True,
        dtype: torch.dtype = torch.float32,
        solver: str = "xla",
        pallas_precision: str = "highest",
        transient_time: float = 200.0,
        device: Optional[torch.device] = None,
    ) -> "KuramotoSivashinsky":
        """``transient_time`` (a field only in the JAX package's ``create``)
        shortens the reset transient for small CPU runs."""
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        if pallas_precision not in pallas_ks_packed.PRECISIONS:
            raise ValueError(f"unknown pallas_precision {pallas_precision!r}")
        if solver != "xla" and dtype != torch.float32:
            raise ValueError("the pallas solvers are float32-only")
        xi_rel = (0.0, 0.25, 0.5, 0.75)
        return cls(
            ops=KSOperators.create(n, length, dtype=dtype, device=device),
            forcing=GaussianForcing.create(n, length, xi_rel, sigma, dtype=dtype,
                                           device=device),
            length=length,
            n=n,
            cfg_steps=cfg_steps,
            t_trans=t_trans,
            t_max=t_max,
            dt=dt,
            noise=noise,
            sigma=sigma,
            lmbda=lmbda,
            objective=objective,
            legacy_objective=legacy_objective,
            xi_rel=xi_rel,
            transient_time=transient_time,
            solver=solver,
            pallas_precision=pallas_precision,
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
        """Control-period length in simulation time (= surrogate time step)."""
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
        # kuramoto.py:72 — any truthy objective string selects l2control.
        if self.legacy_objective:
            return L2CONTROL if self.objective else DISSIPATION
        return self.objective or DISSIPATION

    @property
    def scenario(self) -> Dict:
        """Metadata dict splatted into model/loss constructors
        (kuramoto.py:136-150; ``noise``/``lmbda`` literals kept)."""
        return {
            "cfg_steps": self.cfg_steps,
            "Ttrans": self.t_trans,
            "L": self.length,
            "N": self.n,
            "dx": self.length / self.n,
            "Tmax": self.t_max,
            "dt": self.dt,
            "Xi": list(self.xi_rel),
            "noise": 0.1,
            "lmbda": 1.0,
            "objective": self.objective,
        }

    # --------------------------------------------------------------- physics
    def action_to_phi(self, action: torch.Tensor) -> torch.Tensor:
        """[..., C=1, jets] (or [..., jets]) action -> [..., N] forcing field."""
        if action.shape[-1] != self.num_jets:
            raise ValueError(f"expected {self.num_jets} jets, got {tuple(action.shape)}")
        phi = self.forcing.apply(action.to(self.dtype))
        if phi.ndim >= 2 and phi.shape[-2] == 1:
            phi = phi.squeeze(-2)
        return phi

    def reward_fn(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        """Objective on raw field(s); the world model re-scores imagined
        states with it (reference ``env.reward_func``, kuramoto.py:73)."""
        if u.ndim >= 2 and u.shape[-2] == 1:
            u = u.squeeze(-2)
        if phi.ndim >= 2 and phi.shape[-2] == 1:
            phi = phi.squeeze(-2)
        return ks_reward(self.ops, u, phi.to(u.dtype), self.effective_objective)

    # ----------------------------------------------------------------- reset
    def sample_ic(self, generator: torch.Generator,
                  batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Raw initial condition ``u ~ U(-0.4, 0.4)`` (kuramoto.py:106)."""
        u = torch.rand(batch_shape + (self.n,), generator=generator,
                       dtype=self.dtype, device=self.device)
        return u * 0.8 - 0.4

    @property
    def transient_periods(self) -> int:
        return int(self.transient_time / self.dt / self.cfg_steps)

    def transient(self, u: torch.Tensor, periods: int) -> torch.Tensor:
        """No-op transient through the configured solver; float32 K1 under
        both kernel solvers (the JAX env runs it in float32 whatever the
        solver, ``pdecontrol_tpu/envs/kuramoto.py:236``)."""
        return ks_transient(self.ops, u, self.dt, self.cfg_steps, periods,
                            period_fn=self._period_fn)

    def reset(self, generator: torch.Generator,
              batch_shape: Tuple[int, ...] = ()) -> EnvState:
        """Exact reference reset: random IC + full no-op transient."""
        u = self.sample_ic(generator, batch_shape)
        u = self.transient(u, self.transient_periods)
        return EnvState(
            u=u,
            step=torch.zeros(batch_shape, dtype=torch.int32, device=self.device),
            generator=generator,
        )

    def reset_from_pool(self, generator: torch.Generator, pool: torch.Tensor,
                        batch_shape: Tuple[int, ...] = ()) -> EnvState:
        """Draw on-attractor initial states from a pre-generated pool."""
        idx = torch.randint(0, pool.shape[0], batch_shape, generator=generator,
                            device=pool.device)
        return EnvState(
            u=pool[idx],
            step=torch.zeros(batch_shape, dtype=torch.int32, device=self.device),
            generator=generator,
        )

    # ------------------------------------------------------------------ step
    def observe(self, state: EnvState) -> torch.Tensor:
        return state.u[..., None, :]

    @property
    def _period_fn(self):
        if self.solver in ("pallas", "pallas_packed"):
            return pallas_ks.ks_control_period
        return ks_control_period

    def _control_period(self, u: torch.Tensor, phi: torch.Tensor):
        """Advance one control period through the configured solver.  The
        kernel takes a flat ``[B, N]`` batch; any leading batch shape
        (including none) is flattened through and restored."""
        if self.solver == "xla":
            return ks_control_period(self.ops, u, phi, self.dt, self.cfg_steps,
                                     self.effective_objective)
        batch_shape = u.shape[:-1]
        u2 = u.reshape(-1, self.n).contiguous()
        phi2 = torch.broadcast_to(phi, u.shape).reshape(-1, self.n)
        # An odd flat batch cannot be lane-packed on the TPU: the JAX env
        # sends it to the float32 kernel, dropping the precision.  Kept.
        if self.solver == "pallas_packed" and u2.shape[0] % 2 == 0:
            u2, r2 = pallas_ks_packed.ks_control_period_packed(
                self.ops, u2, phi2, self.dt, self.cfg_steps,
                self.effective_objective, self.pallas_precision,
            )
        else:
            u2, r2 = pallas_ks.ks_control_period(
                self.ops, u2, phi2, self.dt, self.cfg_steps, self.effective_objective
            )
        return u2.reshape(u.shape), r2.reshape(batch_shape)

    def step(self, state: EnvState, action: torch.Tensor) -> Tuple[EnvState, StepOut]:
        """One agent step = one control period (kuramoto.py:78-98).
        Truncation-only episodes; no auto-reset (see ``vec_step``)."""
        phi = self.action_to_phi(action)
        u, reward = self._control_period(state.u, phi)
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
        """Batched step with gym-style auto-reset.

        Sub-envs that truncate get the first observation of a fresh episode
        drawn from ``pool`` (at ``reset_idx`` if given, else at indices drawn
        from ``state.generator``); the true terminal observation is
        ``info["final_obs"]`` (reference ``StoreNObsVecWrapper``,
        pdegym ``common/vec_wrappers.py:21-37``).
        """
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


def make_reset_pool(
    env: KuramotoSivashinsky,
    generator: torch.Generator,
    pool_size: int,
    chains: int = 64,
    decorrelate_periods: int = 40,
) -> torch.Tensor:
    """A pool of on-attractor states for amortised resets.

    ``chains`` independent fields go through the full 200-time-unit no-op
    transient as one batch, then keep snapshotting every
    ``decorrelate_periods`` control periods (10 time units, several Lyapunov
    times) until ``pool_size`` states exist — statistically the reference's
    per-reset transient (kuramoto.py:100-116) at an amortised cost.  The
    transient runs through ``env.transient``, so under either kernel solver on
    the GPU it is one K1 launch per period.
    """
    chains = min(chains, pool_size)
    u = env.sample_ic(generator, (chains,))
    u = env.transient(u, env.transient_periods)

    snapshots = [u]
    rounds = math.ceil(pool_size / chains) - 1
    for _ in range(rounds):
        u = env.transient(u, decorrelate_periods)
        snapshots.append(u)
    return torch.cat(snapshots, dim=0)[:pool_size]
