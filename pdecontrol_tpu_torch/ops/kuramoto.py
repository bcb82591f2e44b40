"""Kuramoto–Sivashinsky right-hand side and time integration in PyTorch
(port of ``pdecontrol_tpu/ops/kuramoto.py``).

    u_t = -u_xxxx - u_xx - 0.5 * (u^2)_x + phi

on a periodic domain, with 2nd-order one-sided (upwind) differences on
``u^2`` selected per point by ``sign(u)``, 6th-order central differences for
``u_xx`` and ``u_xxxx``, classic RK4 with ``cfg_steps`` sub-steps per control
period, and the per-sub-step reward taken *before* each sub-step and averaged
over the period (reference pdegym ``kuramoto.py:64-129``).

This is the plain path: stencils are circulant matrices and every RHS is two
matrix products, batched over any leading dimensions, in float32 or float64.
It is the specification of the CUDA kernel in ``ops/pallas_ks.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pdecontrol_tpu_torch.ops import stencils

# Reward objectives (pdegym kuramoto.py:64-73).
L2CONTROL = "l2control"
DISSIPATION = "dissipation"


@dataclasses.dataclass(frozen=True, eq=False)
class KSOperators:
    """Finite-difference operators for one grid resolution.

    ``central``: ``[N, 2N]`` — columns ``[:N]`` give ``u_xx``, columns
    ``[N:]`` give ``u_xxxx``.  ``upwind``: ``[N, 2N]`` — forward / backward
    one-sided first derivative, applied to ``u^2``.  Both are scaled by
    powers of ``1/dx`` in float64 and then cast to ``dtype``.
    """

    central: torch.Tensor
    upwind: torch.Tensor
    n: int
    dx: float

    @classmethod
    def create(
        cls,
        n: int,
        length: float,
        dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> "KSOperators":
        dx = length / n
        central = stencils.stacked_matrix(
            [stencils.SECOND_DERIV_CENTRAL_6, stencils.FOURTH_DERIV_CENTRAL_6],
            n,
            scales=[1.0 / dx**2, 1.0 / dx**4],
        )
        upwind = stencils.stacked_matrix(
            [stencils.FIRST_DERIV_UPWIND_FWD, stencils.FIRST_DERIV_UPWIND_BWD],
            n,
            scales=[1.0 / dx, 1.0 / dx],
        )
        return cls(
            central=torch.as_tensor(central, dtype=dtype, device=device),
            upwind=torch.as_tensor(upwind, dtype=dtype, device=device),
            n=n,
            dx=dx,
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.central.dtype

    @property
    def device(self) -> torch.device:
        return self.central.device


def ks_derivatives(
    ops: KSOperators, u: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return ``(u_x, u_xx, u_xxxx)``; ``u_x`` is the upwind-selected
    derivative of ``u**2`` (the reference's ``rhs`` and dissipation reward
    both use that field, kuramoto.py:67-70,120-122)."""
    cderivs = u @ ops.central
    u_xx, u_xxxx = cderivs[..., : ops.n], cderivs[..., ops.n :]
    uderivs = (u * u) @ ops.upwind
    fwd, bwd = uderivs[..., : ops.n], uderivs[..., ops.n :]
    u_x = torch.where(u < 0, fwd, bwd)
    return u_x, u_xx, u_xxxx


def ks_rhs(ops: KSOperators, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """dU/dt = -u_xxxx - u_xx - 0.5 * upwind((u^2)_x) + phi (kuramoto.py:127)."""
    u_x, u_xx, u_xxxx = ks_derivatives(ops, u)
    return -u_xxxx - u_xx - 0.5 * u_x + phi


def ks_reward(
    ops: KSOperators, u: torch.Tensor, phi: torch.Tensor, objective: str
) -> torch.Tensor:
    """Per-sub-step reward on the *pre-step* state (kuramoto.py:64-73,84).

    ``l2control``: ``-(1/N) * ||u||_2^2``.  ``dissipation``:
    ``-(mean(u_xx^2) + mean(u_x^2) + mean(u * phi))`` with ``u_x`` the upwind
    derivative of ``u^2`` — a reference quirk kept on purpose.
    """
    if objective == L2CONTROL:
        return -torch.sum(u * u, dim=-1) / ops.n
    if objective == DISSIPATION:
        u_x, u_xx, _ = ks_derivatives(ops, u)
        return -(
            torch.mean(u_xx * u_xx, dim=-1)
            + torch.mean(u_x * u_x, dim=-1)
            + torch.mean(u * phi, dim=-1)
        )
    raise ValueError(f"unknown objective {objective!r}")


def ks_rk4_substep(
    ops: KSOperators, dt: float, u: torch.Tensor, phi: torch.Tensor
) -> torch.Tensor:
    """One classic RK4 sub-step, arithmetic ordered as kuramoto.py:85-90."""
    k1 = ks_rhs(ops, u, phi)
    k2 = ks_rhs(ops, u + dt * k1 / 2.0, phi)
    k3 = ks_rhs(ops, u + dt * k2 / 2.0, phi)
    k4 = ks_rhs(ops, u + dt * k3, phi)
    return u + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def ks_control_period(
    ops: KSOperators,
    u: torch.Tensor,
    phi: torch.Tensor,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance one control period (``cfg_steps`` RK4 sub-steps, fixed
    ``phi``).  Returns ``(u_next, reward)``, the reward being the period
    mean of the per-sub-step objective (kuramoto.py:82-96)."""
    acc = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    for _ in range(cfg_steps):
        acc = acc + ks_reward(ops, u, phi, objective)
        u = ks_rk4_substep(ops, dt, u, phi)
    return u, acc / cfg_steps


PeriodFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def ks_transient(
    ops: KSOperators,
    u: torch.Tensor,
    dt: float,
    cfg_steps: int,
    periods: int,
    period_fn: PeriodFn = ks_control_period,
) -> torch.Tensor:
    """No-op (phi = 0) burn-in onto the chaotic attractor (kuramoto.py:103-109).

    ``period_fn`` advances one control period; the env passes its solver's
    (the CUDA kernel under ``solver="pallas"``), so the transient runs one
    launch per period instead of thousands of small ones.
    """
    phi = torch.zeros_like(u)
    for _ in range(periods):
        u, _ = period_fn(ops, u, phi, dt, cfg_steps, L2CONTROL)
    return u


def gaussian_forcing_matrix(
    x: np.ndarray, xi_rel: np.ndarray, sigma: float, length: float, dtype=np.float64
) -> np.ndarray:
    """Gaussian-jet actuation matrix ``F`` with ``phi = a @ F``.

    Mirrors pdegym ``common/transforms.py:258-260`` including its
    normalisation quirk ``1 / sqrt(2*pi*sigma)`` (sigma not squared).
    """
    xi = (length * np.asarray(xi_rel, dtype=np.float64)).reshape(-1, 1)
    x = np.asarray(x, dtype=np.float64)
    mat = np.exp(-((x - xi) ** 2) / (2.0 * sigma**2))
    mat = mat / np.sqrt(2.0 * np.pi * sigma)
    return mat.astype(dtype)
