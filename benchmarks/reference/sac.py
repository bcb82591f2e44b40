"""Plain Soft Actor-Critic (the ECC'24 reference's ``sac/sac.py:58-132`` and
``sac/policies.py``), written as functions of parameter lists.

Policy: two ReLU layers over the flattened observation, then a mean and a
log standard deviation head (clamped to [-20, 2]); the action is
``tanh(mean + std * noise)`` scaled to the env bounds, its log-probability
the Gaussian's with the tanh correction ``log(scale * (1 - y^2) + 1e-6)``
summed over the action.  Critic: twin Q networks, two ReLU layers each,
on the concatenated observation and action.  An update: the soft target
``r * scale + (1 - terminated) * gamma * (min Q_target(s', a') - alpha *
log pi(a'|s'))``, the two critics' MSE and an Adam step on the critic; the
policy loss ``alpha * log pi - min Q`` against the updated critic and an
Adam step on the policy; then a Polyak step of the target every
``target_update_interval`` updates.  Adam is PyTorch's (beta 0.9, 0.999,
eps 1e-8 outside the square root, bias-corrected).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

Params = List[torch.Tensor]


def policy_head(pp: Params, obs: torch.Tensor):
    b = obs.shape[0]
    x = F.relu(F.linear(obs.reshape(b, -1), pp[0], pp[1]))
    x = F.relu(F.linear(x, pp[2], pp[3]))
    mean = F.linear(x, pp[4], pp[5])
    log_std = torch.clamp(F.linear(x, pp[6], pp[7]), -20.0, 2.0)
    return mean, log_std


def sample(pp: Params, obs: torch.Tensor, noise: torch.Tensor, action_shape,
           low: float = -1.0, high: float = 1.0):
    """(action [B, *action_shape], log-prob [B, 1], deterministic action)."""
    scale, bias = (high - low) / 2.0, (high + low) / 2.0
    mean, log_std = policy_head(pp, obs)
    shape = (obs.shape[0],) + tuple(action_shape)
    mean, log_std = mean.reshape(shape), log_std.reshape(shape)
    std = torch.exp(log_std)
    x = mean + std * noise
    y = torch.tanh(x)
    log_prob = -0.5 * ((x - mean) / std) ** 2 - log_std - 0.5 * math.log(2.0 * math.pi)
    log_prob = log_prob - torch.log(scale * (1.0 - y ** 2) + 1e-6)
    log_prob = torch.sum(log_prob, dim=tuple(range(1, log_prob.ndim))).reshape(-1, 1)
    return y * scale + bias, log_prob, torch.tanh(mean) * scale + bias


def twin_q(qp: Params, obs: torch.Tensor, action: torch.Tensor):
    b = obs.shape[0]
    xu = torch.cat([obs.reshape(b, -1), action.reshape(b, -1)], dim=1)
    q1 = F.linear(F.relu(F.linear(F.relu(F.linear(xu, qp[0], qp[1])), qp[2], qp[3])), qp[4], qp[5])
    q2 = F.linear(F.relu(F.linear(F.relu(F.linear(xu, qp[6], qp[7])), qp[8], qp[9])), qp[10], qp[11])
    return q1, q2


def adam_step(params: Params, grads: Params, state: Dict[str, Params], lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """In place on ``params`` and ``state`` (``exp_avg``, ``exp_avg_sq``,
    ``step`` per parameter)."""
    for i, (p, g) in enumerate(zip(params, grads)):
        step = state["step"][i] + 1
        m = b1 * state["exp_avg"][i] + (1 - b1) * g
        v = b2 * state["exp_avg_sq"][i] + (1 - b2) * g * g
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        p.copy_(p - (lr / bc1) * m / (torch.sqrt(v) / torch.sqrt(bc2) + eps))
        state["step"][i], state["exp_avg"][i], state["exp_avg_sq"][i] = step, m, v


def update(st: Dict, batch: Dict[str, torch.Tensor], gen, cfg: Dict) -> None:
    """One SAC update of the state ``st`` (``policy``, ``critic``,
    ``target`` parameter lists, ``policy_opt`` and ``critic_opt`` Adam
    states, ``updates``), in place; the two noises are drawn from ``gen``,
    the next state's first."""
    obs, actions, nxtobs = batch["obs"], batch["actions"], batch["nxtobs"]
    rewards = batch["rewards"].reshape(-1, 1) * cfg["reward_scale"]
    mask = 1.0 - batch["terminated"].to(torch.float32).reshape(-1, 1)
    alpha, shape = cfg["alpha"], actions.shape[1:]
    with torch.no_grad():
        noise = torch.randn(actions.shape, generator=gen, dtype=obs.dtype, device=obs.device)
        a_next, logp_next, _ = sample(st["policy"], nxtobs, noise, shape)
        q1_t, q2_t = twin_q(st["target"], nxtobs, a_next)
        target = rewards + mask * cfg["gamma"] * (torch.minimum(q1_t, q2_t) - alpha * logp_next)

    critic = [p.detach().requires_grad_(True) for p in st["critic"]]
    q1, q2 = twin_q(critic, obs, actions)
    qf_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)
    grads = torch.autograd.grad(qf_loss, critic)
    with torch.no_grad():
        adam_step(st["critic"], grads, st["critic_opt"], cfg["lr"])

    noise = torch.randn(actions.shape, generator=gen, dtype=obs.dtype, device=obs.device)
    policy = [p.detach().requires_grad_(True) for p in st["policy"]]
    pi, logp, _ = sample(policy, obs, noise, shape)
    q1_pi, q2_pi = twin_q([p.detach() for p in st["critic"]], obs, pi)
    policy_loss = torch.mean(alpha * logp - torch.minimum(q1_pi, q2_pi))
    grads = torch.autograd.grad(policy_loss, policy)
    with torch.no_grad():
        adam_step(st["policy"], grads, st["policy_opt"], cfg["lr"])
        if st["updates"] % cfg["target_update_interval"] == 0:
            for t, s in zip(st["target"], st["critic"]):
                t.copy_(t * (1.0 - cfg["sac_tau"]) + s * cfg["sac_tau"])
    st["updates"] += 1
