"""Training losses (port of ``pdecontrol_tpu/train/losses.py``; reference
``surrogates/phyloss/phyloss.py``).

Losses are elementwise (reduction="none").  ``make_loss`` resolves a name
with the scenario's keyword arguments filtered in, as the reference's
``getattr(phyloss, name)`` with ``ignore_extra_keywords`` (mbrl.py:213-216).
Only ``MSELoss`` is ported so far; the physics-informed losses are not.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor, **_) -> torch.Tensor:
    return (pred - target) ** 2


REGISTRY: Dict[str, Callable] = {
    "MSELoss": lambda **_: mse_loss,
}


def make_loss(name: str, scenario: Dict) -> Callable[..., torch.Tensor]:
    """Resolve a loss by name with scenario kwargs filtered in."""
    if name not in REGISTRY:
        raise NotImplementedError(
            f"loss {name!r} is not yet ported; have {sorted(REGISTRY)}"
        )
    ctor = REGISTRY[name]
    sig = inspect.signature(ctor)
    accepts_any = any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
    )
    kwargs = {k: v for k, v in scenario.items() if accepts_any or k in sig.parameters}
    return ctor(**kwargs)
