"""SAC policy / critic networks (port of ``pdecontrol_tpu/sac/nets.py``;
reference ``pdecontrol/sac/policies.py``).

2x256 ReLU MLPs over flattened ``[C, H]`` observations; a tanh-squashed
Gaussian policy with log-std clamped to [-20, 2] and the squash log-prob
correction summed over channel and action dims (policies.py:112-125); a twin
Q-network on concat(obs, action) (policies.py:36-70).  Xavier-uniform
weights, zero biases (policies.py:11-13).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0
EPSILON = 1e-6


def _dense(in_features: int, out_features: int) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    nn.init.xavier_uniform_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


def _apply(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` on ``x`` in the wider of their dtypes, as flax's ``Dense``
    promotes its input and parameters: float64 parameters on a float32 batch
    (the SAC update's cast) compute in float64, and so do float32 parameters
    on a float64 observation."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class GaussianPolicy(nn.Module):
    def __init__(self, obs_dim: int, achannels: int, asize: int, hidden: int = 256,
                 action_scale: float = 1.0, action_bias: float = 0.0):
        super().__init__()
        self.achannels, self.asize = achannels, asize
        self.action_scale, self.action_bias = action_scale, action_bias
        self.linear1 = _dense(obs_dim, hidden)
        self.linear2 = _dense(hidden, hidden)
        self.mean = _dense(hidden, achannels * asize)
        self.log_std = _dense(hidden, achannels * asize)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = obs.shape[0]
        x = F.relu(_apply(self.linear1, obs.reshape(b, -1)))
        x = F.relu(_apply(self.linear2, x))
        mean = _apply(self.mean, x)
        log_std = torch.clamp(_apply(self.log_std, x), LOG_SIG_MIN, LOG_SIG_MAX)
        shape = (b, self.achannels, self.asize)
        return mean.reshape(shape), log_std.reshape(shape)

    def sample(
        self,
        obs: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Reparameterised sample -> (action, log_prob [B, 1], det_mean).
        ``noise`` (standard normal, the shape of the mean) is drawn from
        ``generator`` unless given."""
        mean, log_std = self(obs)
        std = torch.exp(log_std)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                device=mean.device)
        x_t = mean + std * noise
        y_t = torch.tanh(x_t)
        action = y_t * self.action_scale + self.action_bias

        # Normal log-prob + tanh-squash correction (policies.py:119-123).
        log_prob = (-0.5 * ((x_t - mean) / std) ** 2 - log_std
                    - 0.5 * math.log(2.0 * math.pi))
        log_prob = log_prob - torch.log(self.action_scale * (1.0 - y_t**2) + EPSILON)
        log_prob = torch.sum(log_prob, dim=(1, 2)).reshape(-1, 1)

        det = torch.tanh(mean) * self.action_scale + self.action_bias
        return action, log_prob, det


class QNetwork(nn.Module):
    """Twin Q (policies.py:36-70)."""

    def __init__(self, in_dim: int, hidden: int = 256):
        super().__init__()
        self.linear1 = _dense(in_dim, hidden)
        self.linear2 = _dense(hidden, hidden)
        self.linear3 = _dense(hidden, 1)
        self.linear4 = _dense(in_dim, hidden)
        self.linear5 = _dense(hidden, hidden)
        self.linear6 = _dense(hidden, 1)

    def forward(self, obs: torch.Tensor, action: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = obs.shape[0]
        xu = torch.cat([obs.reshape(b, -1), action.reshape(b, -1)], dim=1)
        x1 = _apply(self.linear3, F.relu(_apply(self.linear2, F.relu(_apply(self.linear1, xu)))))
        x2 = _apply(self.linear6, F.relu(_apply(self.linear5, F.relu(_apply(self.linear4, xu)))))
        return x1, x2
