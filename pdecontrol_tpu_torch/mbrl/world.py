"""Imagined (world-model) vectorised environment (port of
``pdecontrol_tpu/mbrl/world.py``; reference ``mbrl/world/world.py``).

Reference semantics kept:
  * ``reset`` draws a batch of (left-padded) tau-step warmup windows from the
    real replay, teacher-forces every ensemble member over them, and returns
    the elite-selected last prediction (world.py:176-204);
  * ``step`` advances every member one control period on the previous
    *selected* outputs, re-entering the teacher-forcing branch on the
    previous prediction each step (world.py:159-161);
  * rewards come from inverse-transforming the predicted obs and the
    forcing-field action back to physical space and applying the real env's
    reward function (world.py:164-171);
  * the whole batch resets only when EVERY sub-env has hit the rollout
    horizon or the env time limit (world.py:122-134); ``terminated`` is
    always False.

The auto-reset takes the JAX package's form (``pdecontrol_tpu/mbrl/world.py``
``step``): a fresh state is drawn at every step and picked on the device, so
no value goes to the host and the step runs inside a CUDA graph.

With a ``mesh`` (``parallel/mesh.py``) the batch is sharded over ``data``:
``reset`` and ``step`` hold this rank's rows, every draw is made for the
whole batch and the rank keeps its rows, and the batch is done when it is
done on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.mbrl.transform_sets import ControllerTransforms
from pdecontrol_tpu_torch.models.surrogate import (
    EnsembleState,
    ensemble_rollout,
    select_elites,
)


@dataclasses.dataclass
class WorldState:
    obs: torch.Tensor  # [B, C, H] last selected prediction (world space)
    hidden: Any  # per-member transition carries, leading axis M
    timesteps: torch.Tensor  # [B] env-step counter (starts at warmup offset)
    simulated: torch.Tensor  # [] int64 steps since reset


def _pick(cond: torch.Tensor, a: WorldState, b: WorldState) -> WorldState:
    """``a`` where the scalar ``cond`` holds, else ``b``, field by field."""
    return WorldState(
        obs=torch.where(cond, a.obs, b.obs),
        hidden=tuple(torch.where(cond, x, y) for x, y in zip(a.hidden, b.hidden)),
        timesteps=torch.where(cond, a.timesteps, b.timesteps),
        simulated=torch.where(cond, a.simulated, b.simulated),
    )


class WorldModel:
    """Static config of the imagined env; its state is explicit."""

    def __init__(self, num_envs: int, max_episode_steps: int, reward_fn, tau: int,
                 mesh=None):
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.reward_fn = reward_fn
        self.tau = tau
        self.mesh = mesh
        # This rank's rows of the batch.
        self.rows = None if mesh is None else mesh.data_slice(num_envs)

    @torch.no_grad()
    def reset(self, generator: Optional[torch.Generator], ens: EnsembleState,
              replay: R.ReplayState, tr: ControllerTransforms) -> WorldState:
        batch = R.sample_starting(replay, generator, self.num_envs, self.tau)
        if self.rows is not None:
            batch = batch.apply(lambda x: x[self.rows])
        return self.reset_from_batch(generator, ens, tr.replay_to_world(batch), tr,
                                     rows=self.rows)

    @torch.no_grad()
    def reset_from_batch(self, generator: Optional[torch.Generator],
                         ens: EnsembleState, batch, tr: ControllerTransforms,
                         rows: Optional[slice] = None) -> WorldState:
        """Teacher-force every member over an explicit world-space warmup
        window and return the elite-selected last prediction
        (world.py:176-204).  ``rows``: the batch is those rows of the
        ``num_envs`` (``select_elites``)."""
        roll = ensemble_rollout(ens, batch.obs, batch.actions,
                                dscaling=tr.undscaling.inv)
        selected, _ = self._select(generator, ens, roll.outputs[:, :, -1], rows)
        return WorldState(
            obs=selected,
            hidden=roll.hidden,
            timesteps=batch.steps[:, -1].to(torch.int64),
            simulated=torch.zeros((), dtype=torch.int64, device=selected.device),
        )

    @torch.no_grad()
    def advance(self, generator: Optional[torch.Generator], state: WorldState,
                ens: EnsembleState, waction: torch.Tensor, tr: ControllerTransforms,
                rows: Optional[slice] = None) -> Tuple[WorldState, torch.Tensor]:
        """One imagined step without truncation: advance every member one
        control period on the previous *selected* outputs, elite-select, and
        score the physical-space reward (world.py:147-174).  ``rows`` as in
        ``reset_from_batch``."""
        roll = ensemble_rollout(ens, state.obs[:, None], waction[:, None],
                                dscaling=tr.undscaling.inv, hidden=state.hidden)
        selected, _ = self._select(generator, ens, roll.outputs[:, :, -1], rows)
        phys_obs = tr.world_to_raw_obs(selected)
        phys_phi = tr.world_action_to_phys_field(waction)
        reward = self.reward_fn(phys_obs, phys_phi)
        stepped = WorldState(
            obs=selected,
            hidden=roll.hidden,
            timesteps=state.timesteps + 1,
            simulated=state.simulated + 1,
        )
        return stepped, reward

    def _select(self, generator, ens, outputs, rows):
        total = None if rows is None else self.num_envs
        return select_elites(generator, ens, outputs, rows=rows, total=total)

    @torch.no_grad()
    def step(self, generator: Optional[torch.Generator], state: WorldState,
             ens: EnsembleState, agent_action: torch.Tensor,
             tr: ControllerTransforms, horizon: int, replay: R.ReplayState,
             reset: bool = True):
        """One imagined step + batch auto-reset.  Returns ``(state, (obs,
        reward, terminated, truncated, final_obs))`` with obs in world space
        (what the imagined replay stores).  The fresh state is drawn whether
        or not the batch is done, as in the JAX package; ``reset=False``
        skips it at a step whose returned state the caller discards (the
        last step of an imagined round), which changes nothing it stores.
        With a mesh, ``state``, ``agent_action`` and what is returned hold
        this rank's rows."""
        env_action = tr.agent_to_env_action(agent_action)
        waction = tr.env_action_to_world(env_action)  # [B, C, H] field
        stepped, reward = self.advance(generator, state, ens, waction, tr, rows=self.rows)

        env_limit = stepped.timesteps >= self.max_episode_steps
        done = env_limit | (stepped.simulated >= horizon)
        all_done = torch.all(done) if self.mesh is None else self.mesh.all(done)
        truncated = torch.broadcast_to(all_done, env_limit.shape)
        terminated = torch.zeros_like(env_limit)
        state = stepped
        if reset:
            state = _pick(all_done, self.reset(generator, ens, replay, tr), stepped)
        return state, (state.obs, reward, terminated, truncated, stepped.obs)
