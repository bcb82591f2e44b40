"""Viscous Burgers equation in PyTorch (port of
``pdecontrol_tpu/ops/burgers.py``).

    u_t = nu * u_xx - u * u_x + phi

with a 2nd-order central first derivative, a 4th-order central second
derivative, periodic boundaries and Heun (improved Euler) time stepping: the
numerics fixed by the reference's ``BurgersPhyPDELoss``
(``surrogates/phyloss/phyloss.py:36-89``).  The episode and actuation
structure mirrors the KS environment (Gaussian jets, ``cfg_steps`` sub-steps
per control period, period-averaged reward).

Stencils are circulant matrices and every RHS evaluation is one
``[B, N] @ [N, 2N]`` product, batched over any leading dimensions, in
float32 or float64.  The JAX package has no kernel for Burgers and neither
has the port: the control period is an eager loop over the sub-steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pdecontrol_tpu_torch.ops import stencils

L2CONTROL = "l2control"
DISSIPATION = "dissipation"


@dataclasses.dataclass(frozen=True, eq=False)
class BurgersOperators:
    """``deriv``: ``[N, 2N]`` — ``u_x`` (central-2 / dx) and ``u_xx``
    (central-4 / dx^2) evaluated in one product.  Scaled by the powers of
    ``1/dx`` in float64 and then cast to ``dtype``."""

    deriv: torch.Tensor
    n: int
    dx: float
    nu: float

    @classmethod
    def create(
        cls,
        n: int,
        length: float,
        nu: float,
        dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> "BurgersOperators":
        dx = length / n
        deriv = stencils.stacked_matrix(
            [stencils.FIRST_DERIV_CENTRAL_2, stencils.SECOND_DERIV_CENTRAL_4],
            n,
            scales=[1.0 / dx, 1.0 / dx**2],
        )
        return cls(deriv=torch.as_tensor(deriv, dtype=dtype, device=device),
                   n=n, dx=dx, nu=nu)

    @property
    def dtype(self) -> torch.dtype:
        return self.deriv.dtype

    @property
    def device(self) -> torch.device:
        return self.deriv.device


def burgers_derivatives(ops: BurgersOperators, u: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    derivs = u @ ops.deriv
    return derivs[..., : ops.n], derivs[..., ops.n :]


def burgers_rhs(ops: BurgersOperators, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """``nu * u_xx - u * u_x + phi`` (phyloss.py:81, plus actuation)."""
    u_x, u_xx = burgers_derivatives(ops, u)
    return ops.nu * u_xx - u * u_x + phi


def burgers_reward(ops: BurgersOperators, u: torch.Tensor, phi: torch.Tensor,
                   objective: str) -> torch.Tensor:
    if objective == L2CONTROL:
        return -torch.sum(u * u, dim=-1) / ops.n
    if objective == DISSIPATION:
        u_x, u_xx = burgers_derivatives(ops, u)
        return -(
            torch.mean(u_xx * u_xx, dim=-1)
            + torch.mean(u_x * u_x, dim=-1)
            + torch.mean(u * phi, dim=-1)
        )
    raise ValueError(f"unknown objective {objective!r}")


def burgers_heun_substep(ops: BurgersOperators, dt: float, u: torch.Tensor,
                         phi: torch.Tensor) -> torch.Tensor:
    """Heun / improved-Euler sub-step, ordered as phyloss.py:83-86."""
    utilde = u + 0.5 * dt * burgers_rhs(ops, u, phi)
    return u + dt * burgers_rhs(ops, utilde, phi)


def burgers_control_period(
    ops: BurgersOperators,
    u: torch.Tensor,
    phi: torch.Tensor,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance one control period; returns ``(u_next, period-mean reward)``,
    the reward taken on the state before each sub-step."""
    acc = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    for _ in range(cfg_steps):
        acc = acc + burgers_reward(ops, u, phi, objective)
        u = burgers_heun_substep(ops, dt, u, phi)
    return u, acc / cfg_steps
