"""Plain Kuramoto-Sivashinsky control period: the benchmark's own statement
of what one environment step computes.

    u_t = -u_xxxx - u_xx - 0.5 * (u^2)_x + phi

on a periodic grid of ``n`` points over ``length``: sixth-order central
differences for ``u_xx`` and ``u_xxxx``, fourth-order one-sided differences
on ``u^2`` picked per point by the sign of ``u`` (forward where ``u < 0``),
classic RK4 with ``steps`` sub-steps of ``dt`` per control period, and the
reward taken on the state before each sub-step and averaged over the
period (pdegym ``kuramoto.py:64-129``).  The stencils are applied with
``torch.roll``: no matrix product, so a matmul precision setting does not
reach them.  Runs in whatever dtype it is given (the checks use float64).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# out[i] = sum_d c_d * u[i + d], periodic.
UPWIND_FWD = {0: -25.0 / 12.0, 1: 4.0, 2: -3.0, 3: 4.0 / 3.0, 4: -1.0 / 4.0}
UPWIND_BWD = {0: 25.0 / 12.0, -1: -4.0, -2: 3.0, -3: -4.0 / 3.0, -4: 1.0 / 4.0}
D2_CENTRAL6 = {-3: 1.0 / 90.0, -2: -3.0 / 20.0, -1: 3.0 / 2.0, 0: -49.0 / 18.0,
               1: 3.0 / 2.0, 2: -3.0 / 20.0, 3: 1.0 / 90.0}
D4_CENTRAL6 = {-4: 7.0 / 240.0, -3: -2.0 / 5.0, -2: 169.0 / 60.0, -1: -122.0 / 15.0,
               0: 91.0 / 8.0, 1: -122.0 / 15.0, 2: 169.0 / 60.0, 3: -2.0 / 5.0,
               4: 7.0 / 240.0}


def apply_taps(u: torch.Tensor, taps: Dict[int, float]) -> torch.Tensor:
    out = torch.zeros_like(u)
    for d, c in taps.items():
        out = out + c * torch.roll(u, shifts=-d, dims=-1)
    return out


def derivatives(u: torch.Tensor, dx: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(upwind (u^2)_x, u_xx, u_xxxx)."""
    u2 = u * u
    fwd = apply_taps(u2, UPWIND_FWD) / dx
    bwd = apply_taps(u2, UPWIND_BWD) / dx
    ux = torch.where(u < 0, fwd, bwd)
    return ux, apply_taps(u, D2_CENTRAL6) / dx ** 2, apply_taps(u, D4_CENTRAL6) / dx ** 4


def reward(u: torch.Tensor, phi: torch.Tensor, dx: float, objective: str) -> torch.Tensor:
    if objective == "l2control":
        return -torch.sum(u * u, dim=-1) / u.shape[-1]
    ux, uxx, _ = derivatives(u, dx)
    return -(torch.mean(uxx * uxx, dim=-1) + torch.mean(ux * ux, dim=-1)
             + torch.mean(u * phi, dim=-1))


def rhs(u: torch.Tensor, phi: torch.Tensor, dx: float) -> torch.Tensor:
    ux, uxx, uxxxx = derivatives(u, dx)
    return -uxxxx - uxx - 0.5 * ux + phi


def control_period(u: torch.Tensor, phi: torch.Tensor, length: float, dt: float,
                   steps: int, objective: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One control period of ``u`` [B, n] under the forcing field ``phi``
    [B, n]: (u after it, the period's mean reward [B])."""
    dx = length / u.shape[-1]
    acc = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    for _ in range(steps):
        acc = acc + reward(u, phi, dx, objective)
        k1 = rhs(u, phi, dx)
        k2 = rhs(u + dt * k1 / 2.0, phi, dx)
        k3 = rhs(u + dt * k2 / 2.0, phi, dx)
        k4 = rhs(u + dt * k3, phi, dx)
        u = u + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    return u, acc / steps


def forcing_matrix(n: int, length: float, sigma: float, xi_rel=(0.0, 0.25, 0.5, 0.75),
                   dtype=torch.float64, device=None) -> torch.Tensor:
    """Gaussian jets, ``phi = a @ F`` with ``F`` [jets, n]; the reference's
    ``1 / sqrt(2 pi sigma)`` normalisation (sigma not squared) kept."""
    x = torch.arange(n, dtype=torch.float64) * (length / n)
    xi = torch.tensor(xi_rel, dtype=torch.float64)[:, None] * length
    mat = torch.exp(-((x[None, :] - xi) ** 2) / (2.0 * sigma ** 2)) / math.sqrt(2.0 * math.pi * sigma)
    return mat.to(dtype=dtype, device=device)


def objective_of(env: Dict) -> str:
    """The objective the env scores: with the legacy flag (the default) any
    non-empty objective string selects l2control (kuramoto.py:72)."""
    objective = env.get("objective", "dissipation")
    if env.get("legacy_objective", True):
        return "l2control" if objective else "dissipation"
    return objective or "dissipation"
