"""Core data records (port of ``pdecontrol_tpu/data/types.py``; reference
``pdecontrol/mbrl/types.py``).

``Sample`` holds a (possibly batched, time-majored) transition record;
``ModelRollout`` holds surrogate rollout products; ``TrainBatch`` a windowed
batch with a validity mask.  Plain dataclasses of tensors: ``apply`` maps a
function over the set fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass
class Sample:
    obs: Optional[torch.Tensor] = None
    actions: Optional[torch.Tensor] = None
    nxtobs: Optional[torch.Tensor] = None
    rewards: Optional[torch.Tensor] = None
    terminated: Optional[torch.Tensor] = None
    truncated: Optional[torch.Tensor] = None
    steps: Optional[torch.Tensor] = None

    def apply(self, fn: Callable) -> "Sample":
        return Sample(*(None if x is None else fn(x) for x in self))

    def replace(self, **changes) -> "Sample":
        return dataclasses.replace(self, **changes)

    def __iter__(self):
        return iter(
            (
                self.obs,
                self.actions,
                self.nxtobs,
                self.rewards,
                self.terminated,
                self.truncated,
                self.steps,
            )
        )


@dataclasses.dataclass
class ModelRollout:
    """Surrogate rollout products (reference types.py:73-82)."""

    outputs: Optional[torch.Tensor] = None  # predicted states [B, T, C, H]
    inlatents: Optional[torch.Tensor] = None
    outlatents: Optional[torch.Tensor] = None
    deltas: Optional[torch.Tensor] = None  # decoded per-step deltas (pre-scaling)
    hidden: Any = None  # transition-model carry


@dataclasses.dataclass
class TrainBatch:
    """Fixed-shape windowed training batch with a validity mask along time."""

    sample: Optional[Sample] = None
    mask: Optional[torch.Tensor] = None  # [B, T] 1.0 where the window is valid
