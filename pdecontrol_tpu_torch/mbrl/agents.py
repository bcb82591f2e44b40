"""Simple agents (port of ``pdecontrol_tpu/mbrl/agents.py``; reference
``pdecontrol/mbrl/utils.py:19-36``).

``RandomAgent`` samples uniform actions; ``ActionRepeatAgent`` replays a
fixed action sequence, for the open-loop surrogate evaluation
(mbrl.py:498-506).  ``RandomAgent.select_action`` has the SAC agent's call
signature, with an explicit ``torch.Generator`` where the JAX package passes
a key.
"""

from __future__ import annotations

from typing import Optional

import torch


class RandomAgent:
    def __init__(self, action_shape, low: float = -1.0, high: float = 1.0):
        self.action_shape = tuple(action_shape)
        self.low, self.high = low, high

    def select_action(self, state, obs: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = False) -> torch.Tensor:
        u = torch.rand((obs.shape[0],) + self.action_shape, generator=generator,
                       dtype=obs.dtype, device=obs.device)
        return self.low + u * (self.high - self.low)


class ActionRepeatAgent:
    """Replays ``actions`` of shape [B, T, C, A], one step per call of
    ``action_at``."""

    def __init__(self, actions: torch.Tensor):
        if actions.ndim != 4:
            raise ValueError(f"actions must be [B, T, C, A], got {tuple(actions.shape)}")
        self.actions = actions

    def action_at(self, t: int) -> torch.Tensor:
        return self.actions[:, t]
