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

The auto-reset keeps the JAX package's draws (``pdecontrol_tpu/mbrl/world.py``
``step``): a fresh state is drawn at every step and the choice is made on the
device, so no value goes to the host and the step runs inside a CUDA graph.
Eagerly the fresh state is computed at every step and picked, as JAX's
``lax.select`` does.  In a graph being captured its ensemble rollout sits in
a conditional node on the device's ``all_done``, so a replay runs it only
where the whole batch is done; what the step returns is the same, bit for
bit.

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
    draw_elites,
    ensemble_rollout,
)
from pdecontrol_tpu_torch.utils.graphs import copy_into, only_if


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


def _elite(outputs: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """Each row's last prediction by its drawn member: ``outputs`` [M, B,
    T, ...] -> [B, ...] (surrogate.py:44-46)."""
    last = outputs[:, :, -1]
    return last[members, torch.arange(last.shape[1], device=last.device)]


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
        batch, members = self._draw_reset(generator, ens, replay)
        return self._start(ens, tr.replay_to_world(batch), members, tr)

    def _draw_reset(self, generator: Optional[torch.Generator], ens: EnsembleState,
                    replay: R.ReplayState):
        """A reset's draws: this rank's rows of the warmup windows, then each
        row's elite member, which the rollout does not feed, so it may be
        drawn before it (the JAX package's order of draws)."""
        batch = R.sample_starting(replay, generator, self.num_envs, self.tau)
        if self.rows is not None:
            batch = batch.apply(lambda x: x[self.rows])
        return batch, draw_elites(generator, ens, self.num_envs, self.rows)

    @torch.no_grad()
    def reset_from_batch(self, generator: Optional[torch.Generator],
                         ens: EnsembleState, batch, tr: ControllerTransforms) -> WorldState:
        """Teacher-force every member over an explicit world-space warmup
        window and return the elite-selected last prediction
        (world.py:176-204)."""
        members = draw_elites(generator, ens, batch.obs.shape[0])
        return self._start(ens, batch, members, tr)

    def _start(self, ens: EnsembleState, batch, members: torch.Tensor,
               tr: ControllerTransforms) -> WorldState:
        """The state after a world-space warmup window: every member
        teacher-forced over it, each row's drawn ``members``' last
        prediction; no draw."""
        roll = ensemble_rollout(ens, batch.obs, batch.actions,
                                dscaling=tr.undscaling.inv)
        return WorldState(
            obs=_elite(roll.outputs, members),
            hidden=roll.hidden,
            timesteps=batch.steps[:, -1].to(torch.int64),
            simulated=torch.zeros((), dtype=torch.int64, device=members.device),
        )

    @torch.no_grad()
    def advance(self, generator: Optional[torch.Generator], state: WorldState,
                ens: EnsembleState, waction: torch.Tensor, tr: ControllerTransforms,
                rows: Optional[slice] = None) -> Tuple[WorldState, torch.Tensor]:
        """One imagined step without truncation: advance every member one
        control period on the previous *selected* outputs, elite-select, and
        score the physical-space reward (world.py:147-174).  ``rows``: the
        batch is those rows of the ``num_envs``, whose members are drawn for
        them all."""
        roll = ensemble_rollout(ens, state.obs[:, None], waction[:, None],
                                dscaling=tr.undscaling.inv, hidden=state.hidden)
        n = state.obs.shape[0] if rows is None else self.num_envs
        selected = _elite(roll.outputs, draw_elites(generator, ens, n, rows))
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

    @torch.no_grad()
    def step(self, generator: Optional[torch.Generator], state: WorldState,
             ens: EnsembleState, agent_action: torch.Tensor,
             tr: ControllerTransforms, horizon: int, replay: R.ReplayState,
             reset: bool = True):
        """One imagined step + batch auto-reset.  Returns ``(state, (obs,
        reward, terminated, truncated, final_obs))`` with obs in world space
        (what the imagined replay stores).  The fresh state is drawn whether
        or not the batch is done, as in the JAX package; eagerly it is also
        computed and picked on the device, and in a graph being captured a
        conditional node computes it only where the batch is done
        (``_start_if``).  ``reset=False`` skips it at a step whose returned
        state the caller discards (the last step of an imagined round),
        which changes nothing it stores.  With a mesh, ``state``,
        ``agent_action`` and what is returned hold this rank's rows."""
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
            batch, members = self._draw_reset(generator, ens, replay)
            if all_done.is_cuda and torch.cuda.is_current_stream_capturing():
                state = self._start_if(all_done, ens, batch, members, tr, stepped)
            else:
                fresh = self._start(ens, tr.replay_to_world(batch), members, tr)
                state = _pick(all_done, fresh, stepped)
        return state, (state.obs, reward, terminated, truncated, stepped.obs)

    def _start_if(self, cond: torch.Tensor, ens: EnsembleState, batch,
                  members: torch.Tensor, tr: ControllerTransforms,
                  stepped: WorldState) -> WorldState:
        """In a CUDA graph being captured: ``stepped``, overwritten by a
        conditional node with the fresh state of the drawn ``batch`` and
        ``members`` where the device's scalar ``cond`` holds.  The node's
        body (the warmup window's transform and every member's rollout over
        it) runs only then, and writes into buffers made before it; the
        frame ``stepped.obs`` stays the step's ``final_obs``."""
        out = dataclasses.replace(stepped, obs=stepped.obs.clone())
        with only_if(cond):
            copy_into(out, self._start(ens, tr.replay_to_world(batch), members, tr))
        return out
