"""The three sharded hot paths over a mesh (port of
``pdecontrol_tpu/parallel/sharded.py``):

  * env collection: the env batch over ``data``, each rank stepping its own
    envs (through K1 or K2 on the card);
  * the ensemble's lock-step gradient step: the members over ``model``,
    each rank training its own members on their batches;
  * the SAC update: the batch over ``data``, each rank's gradients averaged
    over ``data`` before every optimizer step (``sac/sac.py``).

Each of the three returns ``(run, place)`` as the JAX package's do: ``place``
cuts the global inputs to this rank's shard, and ``run`` computes the shard
and returns the global result on every rank, as a replicated output of the
JAX package's programs would be.  The controller (``mbrl/controller.py``)
runs the same three paths through ``sharded_vec_step``,
``SurrogateTrainer.fit_ensemble`` and ``SAC.update_many`` with its mesh.
"""

from __future__ import annotations

import copy

import torch

from pdecontrol_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def sharded_vec_step(mesh: Mesh, env, state, action: torch.Tensor, pool: torch.Tensor):
    """``env.vec_step`` of this rank's envs (``state`` and ``action`` hold
    their rows).  The auto-reset indices are drawn for the whole batch and
    the rank keeps its own, so that the generator advances as in one
    process; the step's outputs are gathered.  Returns the rank's next state
    and the whole batch's ``StepOut``."""
    n = state.u.shape[0] * mesh.data_parallel
    reset_idx = torch.randint(0, pool.shape[0], (n,), generator=state.generator,
                              device=pool.device)[mesh.data_slice(n)]
    state, out = env.vec_step(state, action, pool, reset_idx=reset_idx)
    obs, reward, terminated, truncated, final_obs, step, autoreset = mesh.gather(
        [out.obs, out.reward, out.terminated, out.truncated, out.info["final_obs"],
         out.info["step"], out.info["autoreset"]], DATA_AXIS)
    info = {"final_obs": final_obs, "step": step, "autoreset": autoreset}
    return state, out._replace(obs=obs, reward=reward, terminated=terminated,
                               truncated=truncated, info=info)


def sharded_collect_fn(mesh: Mesh, env, nsteps: int):
    """Batched env stepping with the env axis sharded over ``data``.
    ``run(state, actions, pool)`` takes the rank's rows of the state and of
    the actions ``[nsteps, B, ...]`` and returns the whole next state and
    the rewards ``[nsteps, B]``."""

    def run(state, actions, pool):
        if actions.shape[0] != nsteps:
            raise ValueError(f"{actions.shape[0]} steps of actions, the run takes {nsteps}")
        rewards = []
        for action in actions:
            state, out = sharded_vec_step(mesh, env, state, action, pool)
            rewards.append(out.reward)
        u, step = mesh.gather([state.u, state.step], DATA_AXIS)
        return state.replace(u=u, step=step), torch.stack(rewards)

    def place(state, actions, pool):
        rows = mesh.data_slice(state.u.shape[0])
        return (state.replace(u=state.u[rows], step=state.step[rows]), actions[:, rows],
                pool)

    return run, place


def sharded_ensemble_train_fn(mesh: Mesh, trainer):
    """One lock-step gradient step of all members, the members over
    ``model``: ``run(state, states, actions, und, lr)`` takes the whole
    stacked ``TrainerState`` and this rank's members' batches, steps the
    rank's members and gathers every member's state into ``state`` in
    place; it returns the state and ``{"train_loss": [M]}``.  Each rank
    trains its own members unpartitioned (the JAX package's ``shard_map``);
    the batches are not split over ``data``."""

    def run(state, states, actions, und, lr):
        rows = mesh.model_slice(state.num_members)
        local = state.rows(rows)
        active = torch.ones((local.num_members,), dtype=torch.bool, device=state.params.device)
        losses = trainer.lockstep_train_step(local, states, actions, und, lr, active)
        mesh.gather_rows_(state.tensors(), MODEL_AXIS)
        (losses,) = mesh.gather([losses], MODEL_AXIS)
        return state, {"train_loss": losses}

    def place(stacked_state, batch_states, batch_actions):
        rows = mesh.model_slice(batch_states.shape[0])
        return stacked_state, batch_states[rows], batch_actions[rows]

    return run, place


def sharded_sac_update_fn(mesh: Mesh, sac):
    """The SAC update with the batch over ``data`` and replicated networks:
    ``run(sac_state, batch, generator=None, noise=None)`` takes this rank's
    rows of the batch (and, if given, the whole batch's policy noise) and
    returns the state, updated alike on every rank, and the update's
    metrics over the whole batch."""
    agent = copy.copy(sac)
    agent.mesh = mesh

    def run(sac_state, batch, generator=None, noise=None):
        if noise is not None:
            rows = mesh.data_slice(noise[0].shape[0])
            noise = tuple(x[rows] for x in noise)
        sac_state, metrics = agent.update(sac_state, batch, generator, noise)
        return sac_state, agent.global_metrics(metrics)

    def place(sac_state, batch):
        rows = mesh.data_slice(batch.obs.shape[0])
        return sac_state, batch.apply(lambda x: x[rows])

    return run, place
