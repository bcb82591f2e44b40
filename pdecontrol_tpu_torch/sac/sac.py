"""Soft Actor-Critic (port of ``pdecontrol_tpu/sac/sac.py``; reference
``pdecontrol/sac/sac.py``).

One ``update`` is the reference's sequence (sac.py:58-132): a min-double-Q
entropy-regularised target with ``mask = 1 - terminated`` (the timeout mask:
truncation does not cut the bootstrap), two MSE critic losses and an Adam
step, a reparameterised policy loss against the *updated* critic and its
Adam step, optional automatic entropy tuning, and a Polyak soft target
update every ``target_update_interval`` updates (sac.py:129-130).
``reward_scale`` scales the rewards the update sees.

The networks and Adam states live in ``SACState``; ``update`` changes them
in place and returns the state.  Random draws come from an explicit
``torch.Generator``, or are passed in as ``noise``.

With a ``mesh`` (``parallel/mesh.py``) the agent is data parallel: the
batch it is given is this rank's share of the batch, its policy noise is
drawn for the whole batch and the rank keeps its rows, and each gradient is
averaged over ``data`` before the optimizer step, so that the update on
equal shares is the update on the whole batch and the networks stay equal
on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from pdecontrol_tpu_torch.parallel.mesh import DATA_AXIS
from pdecontrol_tpu_torch.sac.nets import GaussianPolicy, QNetwork

# The metrics of an update that are means over its batch.
BATCH_METRICS = ("qf_loss", "qf1_loss", "qf2_loss", "policy_loss", "alpha_loss",
                 "reward_mean")


class SACConfig(NamedTuple):
    gamma: float = 0.99
    tau: float = 0.005
    alpha: float = 0.2
    lr: float = 3e-4
    hidden: int = 256
    target_update_interval: int = 1
    automatic_entropy_tuning: bool = False
    target_entropy: float = -4.0  # -dim(A); overridden at agent creation
    # Reward scaling inside the soft-Q update; logged metrics stay unscaled.
    reward_scale: float = 1.0


@dataclasses.dataclass
class SACState:
    policy: GaussianPolicy
    critic: QNetwork
    target: QNetwork
    policy_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    log_alpha: torch.Tensor
    alpha_opt: torch.optim.Optimizer
    updates: int
    config: SACConfig


def _adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt.
    On the card the step counters live there too (``capturable``), so that
    a CUDA graph of the updates replays them; the eager loop uses the same
    setting, or the two would round the bias correction differently."""
    params = list(params)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=params[0].device.type == "cuda")


def _set_grads(params, loss: torch.Tensor, mesh=None) -> None:
    """Gradients of ``loss`` for ``params`` only (the other networks the
    loss runs through get none), averaged over ``mesh``'s data axis."""
    params = list(params)
    grads = torch.autograd.grad(loss, params)
    if mesh is not None:
        mesh.mean_(grads, DATA_AXIS)
    for p, g in zip(params, grads):
        p.grad = g


class SAC:
    """Agent definition: network sizes and the update rule."""

    def __init__(self, obs_shape, action_shape, config: SACConfig = SACConfig(),
                 action_low: float = -1.0, action_high: float = 1.0, device=None,
                 check: Optional[Callable] = None, mesh=None):
        """``check``, if given, is called with every update's losses before
        their backward passes (``utils.profiling.FiniteChecks``, the
        ``--debug_nans`` option); ``mesh`` makes the updates data parallel."""
        self.obs_shape = tuple(obs_shape)
        self.action_shape = tuple(action_shape)
        self.config = config._replace(
            target_entropy=-float(action_shape[0] * action_shape[1])
            if config.automatic_entropy_tuning else config.target_entropy
        )
        self.action_scale = (action_high - action_low) / 2.0
        self.action_bias = (action_high + action_low) / 2.0
        self.device = device
        self.check = check
        self.mesh = mesh

    # ------------------------------------------------------------------ init
    def init(self, dtype: torch.dtype = torch.float32) -> SACState:
        """Fresh networks, initialised from torch's global generator."""
        cfg = self.config
        obs_dim = self.obs_shape[0] * self.obs_shape[1]
        act_dim = self.action_shape[0] * self.action_shape[1]
        policy = GaussianPolicy(
            obs_dim, self.action_shape[0], self.action_shape[1], hidden=cfg.hidden,
            action_scale=self.action_scale, action_bias=self.action_bias,
        ).to(self.device, dtype)
        critic = QNetwork(obs_dim + act_dim, hidden=cfg.hidden).to(self.device, dtype)
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.zeros((), dtype=dtype, device=self.device, requires_grad=True)
        return SACState(
            policy=policy,
            critic=critic,
            target=target,
            policy_opt=_adam(policy.parameters(), cfg.lr),
            critic_opt=_adam(critic.parameters(), cfg.lr),
            log_alpha=log_alpha,
            alpha_opt=_adam([log_alpha], cfg.lr),
            updates=0,
            config=cfg,
        )

    # --------------------------------------------------------------- actions
    @torch.no_grad()
    def select_action(self, state: SACState, obs: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = False) -> torch.Tensor:
        action, _, det = state.policy.sample(obs, generator)
        return det if deterministic else action

    # ---------------------------------------------------------------- update
    def _alpha(self, state: SACState):
        if self.config.automatic_entropy_tuning:
            return torch.exp(state.log_alpha.detach())
        return self.config.alpha

    def update(
        self,
        state: SACState,
        batch,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """One SAC update on ``batch``.  ``noise`` = (next-state policy
        noise, current-state policy noise), each shaped like the action
        batch; drawn from ``generator`` if not given.  With a mesh the
        metrics are this rank's (``global_metrics`` averages them)."""
        cfg = self.config
        obs, actions, nxtobs = batch.obs, batch.actions, batch.nxtobs
        rewards = batch.rewards.reshape(-1, 1) * cfg.reward_scale
        mask = 1.0 - batch.terminated.to(torch.float32).reshape(-1, 1)
        if noise is None and self.mesh is not None:
            noise = self._shard_noise(state, obs.shape[0], generator)
        noise_next, noise_pi = noise if noise is not None else (None, None)
        alpha = self._alpha(state)

        # ---- critic target (sac.py:75-84)
        with torch.no_grad():
            next_action, next_log_pi, _ = state.policy.sample(
                nxtobs, generator, noise=noise_next)
            q1_t, q2_t = state.target(nxtobs, next_action)
            min_q_t = torch.minimum(q1_t, q2_t) - alpha * next_log_pi
            next_q = rewards + mask * cfg.gamma * min_q_t

        # ---- critic step (sac.py:86-99)
        q1, q2 = state.critic(obs, actions)
        qf1_loss = torch.mean((q1 - next_q) ** 2)
        qf2_loss = torch.mean((q2 - next_q) ** 2)
        qf_loss = qf1_loss + qf2_loss
        if self.check is not None:
            self.check("the SAC update", qf_loss=qf_loss)
        _set_grads(state.critic.parameters(), qf_loss, self.mesh)
        state.critic_opt.step()

        # ---- policy step against the updated critic (sac.py:101-112)
        pi, log_pi, _ = state.policy.sample(obs, generator, noise=noise_pi)
        q1_pi, q2_pi = state.critic(obs, pi)
        policy_loss = torch.mean(alpha * log_pi - torch.minimum(q1_pi, q2_pi))
        if self.check is not None:
            self.check("the SAC update", policy_loss=policy_loss)
        _set_grads(state.policy.parameters(), policy_loss, self.mesh)
        state.policy_opt.step()

        # ---- optional automatic entropy tuning (sac.py:114-123)
        alpha_loss = torch.zeros((), device=obs.device)
        if cfg.automatic_entropy_tuning:
            alpha_loss = -torch.mean(
                state.log_alpha * (log_pi.detach() + cfg.target_entropy))
            _set_grads([state.log_alpha], alpha_loss, self.mesh)
            state.alpha_opt.step()

        # ---- Polyak soft update every interval (sac.py:129-130).  The host
        # counter picks the branch, so a CUDA graph of a chain of updates
        # holds the pattern of the chain it captured.
        if state.updates % cfg.target_update_interval == 0:
            with torch.no_grad():
                for t, s in zip(state.target.parameters(), state.critic.parameters()):
                    t.copy_(t * (1.0 - cfg.tau) + s * cfg.tau)
        state.updates += 1

        metrics = {
            "qf_loss": qf_loss.detach(),
            "qf1_loss": qf1_loss.detach(),
            "qf2_loss": qf2_loss.detach(),
            "policy_loss": policy_loss.detach(),
            "alpha_loss": alpha_loss.detach(),
            "alpha": torch.as_tensor(alpha),
            "reward_mean": torch.mean(rewards),
        }
        return state, metrics

    def _shard_noise(self, state: SACState, rows: int,
                     generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, ...]:
        """This rank's rows of the two policy noises of the whole batch,
        drawn in the order in which one process draws them."""
        n = rows * self.mesh.data_parallel
        p = next(state.policy.parameters())
        return tuple(torch.randn((n,) + self.action_shape, generator=generator, dtype=p.dtype,
                                 device=p.device)[self.mesh.data_slice(n)]
                     for _ in range(2))

    def global_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """An update's metrics over the whole batch: each rank's means over
        its equal share, averaged over ``data``.  Without a mesh, as they
        are."""
        if self.mesh is None or not metrics:
            return metrics
        means = [metrics[k].clone() for k in BATCH_METRICS]
        self.mesh.mean_(means, DATA_AXIS)
        return {**metrics, **dict(zip(BATCH_METRICS, means))}

    def update_many(self, state: SACState, batches,
                    generator: Optional[torch.Generator] = None):
        """Chained updates over a sequence of batches (reference loop
        mbrl.py:562-564); returns the state and the last update's metrics
        (over the whole batch)."""
        metrics = {}
        for batch in batches:
            state, metrics = self.update(state, batch, generator)
        return state, self.global_metrics(metrics)
