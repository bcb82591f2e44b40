"""Training losses incl. the physics-informed variants (port of
``pdecontrol_tpu/train/losses.py``; reference
``surrogates/phyloss/phyloss.py``).

Losses are elementwise (reduction="none").  ``make_loss`` resolves a name
with the scenario's keyword arguments filtered in, as the reference's
``getattr(phyloss, name)`` with ``ignore_extra_keywords`` (mbrl.py:213-216).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict

import torch

from pdecontrol_tpu_torch.ops.burgers import BurgersOperators, burgers_rhs
from pdecontrol_tpu_torch.ops.kuramoto import KSOperators, ks_rhs


def mse_loss(pred: torch.Tensor, target: torch.Tensor, **_) -> torch.Tensor:
    return (pred - target) ** 2


class PhyPDELoss:
    """MSE between a predicted sequence and its own one-step physics
    evolution, shifted by one frame (phyloss.py:13-25).

    Subclasses supply ``rhs`` and ``ops`` (the unforced PDE right-hand side
    on ``[rows, H]``); ``phyevolve`` is one Heun step of it, matching the
    reference's explicit two-stage update (phyloss.py:74-86).  The trainer
    calls a loss as ``loss_fn(out, target)``; this one reads only its first
    argument.  The reference's base class is abstract and cannot run by
    name; ``make_loss("PhyPDELoss", scenario)`` dispatches to the scenario's
    PDE family (``nu`` present -> Burgers, else Kuramoto-Sivashinsky).

    ``ops`` is built in float32 on the CPU, as the JAX package builds it, and
    never changes; ``ops_like`` hands out its copy in an input's dtype and on
    its device (the float32-rounded values, made once for each pair).
    """

    rhs: Callable = None
    ops = None

    def __init__(self, dt: float):
        self.dt = dt
        self._ops_by_kind = {}

    def ops_like(self, u: torch.Tensor):
        if self.ops is None:  # pragma: no cover - abstract
            raise NotImplementedError
        kind = (u.dtype, u.device)
        if kind not in self._ops_by_kind:
            tensors = {
                f.name: getattr(self.ops, f.name).to(dtype=u.dtype, device=u.device)
                for f in dataclasses.fields(self.ops)
                if isinstance(getattr(self.ops, f.name), torch.Tensor)
            }
            self._ops_by_kind[kind] = dataclasses.replace(self.ops, **tensors)
        return self._ops_by_kind[kind]

    def residual(self, u: torch.Tensor) -> torch.Tensor:
        b, t, c, h = u.shape
        flat = u.reshape(b * t * c, h)
        return self.rhs(self.ops_like(u), flat, torch.zeros_like(flat)).reshape(b, t, c, h)

    def phyevolve(self, u: torch.Tensor) -> torch.Tensor:
        utilde = u + 0.5 * self.dt * self.residual(u)
        return u + self.dt * self.residual(utilde)

    def __call__(self, augmented: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        phytargets = self.phyevolve(augmented)
        phytargets = torch.cat(
            (augmented[:, -1:, :, :], phytargets[:, :-1, :, :]), dim=1
        )
        return (augmented - phytargets) ** 2


class KSPhyPDELoss(PhyPDELoss):
    """Physics loss for Kuramoto-Sivashinsky: the unforced KS residual
    (``-u_xxxx - u_xx - 0.5 * upwind((u^2)_x)``, ops/kuramoto.py) under the
    shared Heun evolution.  No reference counterpart (the reference ships
    only the Burgers residual, phyloss.py:36-89); consumes the env
    scenario's ``L``/``N``/``dt``."""

    rhs = staticmethod(ks_rhs)

    def __init__(self, L: float, dt: float, N: int = 64, **_):
        super().__init__(dt)
        self.ops = KSOperators.create(N, L)


class BurgersPhyPDELoss(PhyPDELoss):
    """Physics loss with the Burgers FD residual + Heun step
    (phyloss.py:36-89); consumes the env scenario's ``dx``/``dt``/``nu``."""

    rhs = staticmethod(burgers_rhs)

    def __init__(self, dx: float, dt: float, nu: float, N: int = 64, **_):
        super().__init__(dt)
        self.dx, self.nu = dx, nu
        self.ops = BurgersOperators.create(N, N * dx, nu)


# Every loss of this module is resolvable by its class or alias name,
# mirroring the reference's module-level getattr (mbrl.py:213).
REGISTRY: Dict[str, Callable] = {
    "MSELoss": lambda **_: mse_loss,
    "KSPhyPDELoss": KSPhyPDELoss,
    "BurgersPhyPDELoss": BurgersPhyPDELoss,
}


def make_loss(name: str, scenario: Dict) -> Callable[..., torch.Tensor]:
    """Resolve a loss by name with scenario kwargs filtered in.

    ``"PhyPDELoss"`` dispatches on the scenario: Burgers when ``nu`` is
    present, KS otherwise — the base class itself has no residual."""
    if name == "PhyPDELoss":
        name = "BurgersPhyPDELoss" if "nu" in scenario else "KSPhyPDELoss"
    if name not in REGISTRY:
        raise KeyError(f"unknown loss {name!r}; have {sorted(REGISTRY)}")
    ctor = REGISTRY[name]
    sig = inspect.signature(ctor)
    accepts_any = any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
    )
    kwargs = {k: v for k, v in scenario.items() if accepts_any or k in sig.parameters}
    return ctor(**kwargs)
