"""MBPO-style model-based controller: the ``learn()`` loop (port of
``pdecontrol_tpu/mbrl/controller.py``; reference ``mbrl/mbrl.py``,
PDEModelBasedController).

Loop structure (reference ``learn``, mbrl.py:384-449): warmup with random
actions (``learning_starts``), then per iteration:

  1. collect ``num_envs x rollout_length`` real samples;
  2. every ``surrogate_train_freq`` samples: refit the delta Normalize over
     the whole replay (mbrl.py:597-602) and
  3. retrain every ensemble member with early stopping on the unscaled
     free-run val loss, then update the elites: by default all members in
     lock-step (``SurrogateTrainer.fit_ensemble``), on the card each TBPTT
     step and each validation step a replayed CUDA graph;
     ``--no_fuse_fit`` runs the same fit eagerly, and
     ``--sequential_member_training`` fits one member after another;
  4. imagined rollouts from replay starting states at the scheduled horizon;
  5. ``policy_train_steps_per_sample x samples`` SAC updates on a uniform
     mixture of real and imagined transitions (mbrl.py:529-566);
  6. periodic policy / surrogate evaluation and a status table; at the
     ``logging_freq`` cadence the evaluations' trajectories go to
     ``<run_dir>/evaluation/*.npz`` and comparison plots to
     ``<run_dir>/plots/*.png``, written by one background thread;
  7. every ``checkpoint_freq`` iterations a snapshot of the whole training
     state (``utils/checkpoint.py``); ``resume`` carries on from the last.

By default (``fuse_iteration``, as in the JAX package) an iteration that
does not retrain runs phases 1, 4 and 5 and packs its log scalars as one
body (``_fused_body``, the counterpart of the JAX package's
``_fused_iteration_fn``).  On the card the first such iteration of a horizon
captures the body as a CUDA graph (``utils/graphs.py``) and every later one
replays it; on the CPU the body runs eagerly.  Its record is pulled one
iteration late (``t_dispatch``, then ``t_ready`` when the next iteration
commits it), or at once on an evaluation iteration (``t_fused``).  A
retrain iteration runs the phases one after another without a
synchronisation between them, and ``--no_fuse_iteration`` runs every
iteration so, each phase ending in a device synchronisation before its
``t_*`` timer stops, so that those timings are honest wall times.  On the
card each phase is a CUDA graph there too, as the JAX package runs its
per-phase programs: ``collect`` keyed as ``_collect_jit`` (steps, random),
``imagine`` as ``_world_jit`` (horizon, rounds) and ``update_policy`` as
``_policy_jit`` (updates), as are the evaluations (``evaluate_policy`` by
its episodes' length and count, ``surrogate_rollout`` by its horizon, as
``_sur_eval_jit``).  The first call of a key runs eagerly and the capture
follows it; the record of the iteration carries the captures made since
the previous record (``t_capture``, ``graph_pool_mb``).  The random warmup
runs eagerly: it runs once.  Every body writes the controller's state in
place, in both modes, since a graph reads and writes fixed addresses.  The
phases run eagerly on the CPU, under ``--debug_nans`` (whose checks wait
for the device), and in a controller built with ``graphs=False``; under a
mesh the backend decides (``graph_routes``).

A resumed run repeats neither the random warmup nor the initial policy
evaluation (the JAX package repeats both, ``controller.py:1255-1266``): its
replay, generator and counters are the snapshot's, so it goes on exactly as
the uninterrupted run would have; only the wall-clock fields restart.
The JAX package's precompile ladder and wandb (logging, image and artifact
uploads) are not ported; the option that asks for wandb raises.

A ``data_parallel x model_parallel`` mesh larger than 1x1 is one process per
rank (``parallel/``): each rank steps its share of the envs and of the
imagined batch and takes its share of every SAC batch (``data``), and fits
its share of the members (``model``).  Every draw is made at its global
size from a generator seeded alike on every rank, and what the ranks share
(the replays, the scalings, the networks, the members, the records) is
gathered so that it is equal on every rank and equals the one-process run
but for rounding.  Evaluation and the delta refit run on every rank alike.
Only the primary rank writes files.  Under a mesh of NCCL ranks, a card
each, the fused iteration, the phases and the evaluations replay CUDA
graphs that hold the mesh's collectives, as the JAX package compiles its
mesh path like its single-device path; under gloo, whose collectives run
on the host and cannot be captured, they run eagerly.  The fits hold no
collective and replay their graphs under either backend.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.data.types import Sample
from pdecontrol_tpu_torch.envs import burgers as burgers_env
from pdecontrol_tpu_torch.envs import kuramoto as ks_env
from pdecontrol_tpu_torch.mbrl.agents import ActionRepeatAgent, RandomAgent
from pdecontrol_tpu_torch.mbrl.config import MBPOConfig
from pdecontrol_tpu_torch.mbrl.transform_sets import ControllerTransforms
from pdecontrol_tpu_torch.mbrl.world import WorldModel
from pdecontrol_tpu_torch.models import factories
from pdecontrol_tpu_torch.models.surrogate import (
    EnsembleState,
    init_ensemble,
    update_elites,
)
from pdecontrol_tpu_torch.parallel import distributed
from pdecontrol_tpu_torch.parallel import mesh as meshlib
from pdecontrol_tpu_torch.parallel.sharded import sharded_vec_step
from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig
from pdecontrol_tpu_torch.train.losses import make_loss
from pdecontrol_tpu_torch.train.schedulers import Scheduler
from pdecontrol_tpu_torch.train.trainer import SurrogateTrainer, TrainConfig
from pdecontrol_tpu_torch.utils import checkpoint as C
from pdecontrol_tpu_torch.utils import profiling
from pdecontrol_tpu_torch.utils.asyncviz import BackgroundRenderer
from pdecontrol_tpu_torch.utils.device import entry_device
from pdecontrol_tpu_torch.utils.graphs import GraphCache, copy_into, on_rank, tensors_of
from pdecontrol_tpu_torch.utils.logging import MetricsLogger

ENVS = {
    "KuramotoSivashinskyEnv-v0": (ks_env.KuramotoSivashinsky, ks_env.make_reset_pool),
    "BurgersEnv-v0": (burgers_env.Burgers, burgers_env.make_reset_pool),
}

STATUS_HEADERS = [
    "iteration", "time", "num_ensemble_updates", "num_pol_updates",
    "num_steps_sampled", "eval_return_mean", "world_return_mean", "horizon",
    "world_buffer_samples", "train_loss", "val_loss", "sac_qf_loss",
    "sac_policy_loss",
]

# Per-iteration log scalars, pulled to the host in one transfer.
LOG_SCALARS = ("world_buffer_samples", "collect_reward_mean",
               "imagined_reward_mean", "sac_qf_loss", "sac_policy_loss",
               "total_steps")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place writes to ``x`` cannot reach."""
    return x.detach().to("cpu", copy=True).numpy()


def check_ported(cfg: MBPOConfig) -> None:
    """Raise for the option that names a feature the port lacks: wandb.  An
    env, factory or loss name that no registry holds is a ``KeyError``
    where it is looked up, as in the JAX package."""
    if cfg.use_wandb:
        raise NotImplementedError("not yet ported: wandb logging")


def graph_routes(mesh: Optional[meshlib.Mesh], debug_nans: bool) -> Dict[str, bool]:
    """Which routes may replay CUDA graphs (on the card, in a controller
    built with ``graphs``): ``fused``, the fused iteration; ``phases``, the
    phases and the evaluations; ``fit``, the lock-step and the one-member
    fits.  ``--debug_nans`` turns every graph off: its checks read the
    host.  The fused iteration and the phases hold the mesh's collectives,
    which a graph captures under NCCL but not under gloo; the fits hold
    none (a rank draws every member's batch and keeps its own rows, and the
    gathers run between the replays), so they follow the single-device
    rule under either backend."""
    collectives = not debug_nans and (mesh is None or mesh.backend == "nccl")
    return {"fused": collectives, "phases": collectives, "fit": not debug_nans}


def mesh_for(cfg: MBPOConfig) -> Optional[meshlib.Mesh]:
    """The config's device mesh, or None for 1x1 (the single-device path,
    untouched).  The batches must split over their axes (the JAX package's
    checks and messages, ``mbrl/controller.py:87-116``), and the process
    must be one rank of a process group of the mesh's size."""
    if cfg.data_parallel * cfg.model_parallel == 1:
        return None
    for name, val, axis in (
        ("num_envs", cfg.num_envs, cfg.data_parallel),
        ("model_rollouts_batch_size", cfg.model_rollouts_batch_size, cfg.data_parallel),
        ("policy_batch_size", cfg.policy_batch_size, cfg.data_parallel),
        ("num_dynamics_models", cfg.num_dynamics_models, cfg.model_parallel),
    ):
        if val % axis != 0:
            raise ValueError(f"{name}={val} not divisible by its mesh axis size {axis}")
    return meshlib.make_mesh(cfg.data_parallel, cfg.model_parallel)


class PDEModelBasedController:
    def __init__(self, config: MBPOConfig, logger: Optional[MetricsLogger] = None,
                 device: Optional[torch.device] = None, debug_nans: bool = False,
                 graphs: bool = True):
        """``graphs=False`` runs every phase and the fit eagerly on the card
        too (the routes' reference)."""
        check_ported(config)
        self.config = cfg = config
        self.mesh = mesh_for(cfg)
        # File I/O is the primary rank's.
        self.primary = distributed.is_primary()
        self.device = dev = entry_device(device)
        # --debug_nans: finiteness checks at the phase boundaries.
        self.finite = profiling.FiniteChecks() if debug_nans else None
        # The routes that may replay graphs: none under --debug_nans, whose
        # checks read the host; under a mesh the fused iteration and the
        # phases only where a graph captures the collectives (NCCL).
        self.routes = graph_routes(self.mesh, debug_nans)
        self.fused = cfg.fuse_iteration and self.routes["fused"]
        if cfg.fuse_iteration and debug_nans:
            print("[fuse] --debug_nans runs the eager phases", flush=True)
        if cfg.fuse_fit and cfg.vmap_ensemble_training and debug_nans:
            print("[fuse] --debug_nans runs the eager fit", flush=True)
        # This rank's envs.
        self.env_rows = (slice(None) if self.mesh is None
                         else self.mesh.data_slice(cfg.num_envs))
        if self.mesh is not None:
            m = self.mesh
            members = m.model_slice(cfg.num_dynamics_models)
            graphed = graphs and dev.type == "cuda"
            if not graphed or debug_nans:
                why = ("every route runs eagerly (" + ("--debug_nans" if debug_nans else
                       "graphs=False" if not graphs else "no card") + ")")
            elif self.routes["phases"]:
                why = ("the fused iteration, the phases, the evaluations and the fits "
                       "replay CUDA graphs, which hold NCCL's collectives")
            else:
                why = (f"the fits replay CUDA graphs; the fused iteration, the phases and "
                       f"the evaluations run eagerly, since {m.backend}'s collectives run "
                       f"on the host and no graph captures them")
            print(f"[mesh] {m.data_parallel}x{m.model_parallel}, rank {m.rank} (data "
                  f"{m.data_index}, model {m.model_index}) on {dev} through {m.backend}: "
                  f"envs {self.env_rows.start}:{self.env_rows.stop} of {cfg.num_envs}, "
                  f"members {members.start}:{members.stop} of {cfg.num_dynamics_models}; "
                  f"{why}", flush=True)
        torch.manual_seed(cfg.seed)  # module initialisation
        self.gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        if cfg.env_id not in ENVS:
            raise KeyError(f"unknown env {cfg.env_id!r}; have {sorted(ENVS)}")
        env_cls, make_pool = ENVS[cfg.env_id]
        self.env = env_cls.create(**cfg.env_config, device=dev)

        # Runtime accounting (mbrl.py:88-97).
        self.samples_per_iteration = cfg.num_envs * cfg.rollout_length
        self.num_pol_updates_per_iteration = int(
            cfg.policy_train_steps_per_sample * self.samples_per_iteration
        )
        if self.fused and self.num_pol_updates_per_iteration % cfg.target_update_interval:
            # A graph holds the target-update pattern of the chain it captured.
            raise ValueError(
                f"the fused iteration runs {self.num_pol_updates_per_iteration} SAC "
                f"updates, not a multiple of target_update_interval "
                f"{cfg.target_update_interval}: pass --no_fuse_iteration")
        self.sur_train_freq = max(
            int(cfg.surrogate_train_freq / self.samples_per_iteration), 1
        )
        self.iteration = 0
        self.num_ensemble_updates = 0
        self.num_pol_updates = 0

        self.schedule = Scheduler.factory(cfg.rollout_length_schedule)
        self.curriculum = Scheduler.factory(cfg.curriculum)

        # Transforms + reset pool.
        if cfg.world_stride > 1:
            raise ValueError(
                "world_stride > 1 is not runnable: the world env recomputes "
                "rewards through the inverse world sensor, which is undefined "
                "for strided subsampling (reference SensorTransform._Inverse "
                "raises NotImplementedError too, transforms.py:240-247)"
            )
        self.tr = ControllerTransforms.create(
            self.env, agent_stride=cfg.agent_stride, world_stride=cfg.world_stride,
            dtype=self.env.dtype, device=dev,
        )
        self.pool = make_pool(self.env, self.gen, cfg.pool_size)

        dummy_obs = torch.zeros((1,) + tuple(self.env.obs_shape),
                                dtype=self.env.dtype, device=dev)
        dummy_act = torch.zeros((1,) + tuple(self.env.action_shape),
                                dtype=self.env.dtype, device=dev)
        self.world_obs_shape = tuple(self.tr.raw_to_world_obs(dummy_obs).shape[1:])
        self.agent_obs_shape = tuple(self.tr.raw_to_agent_obs(dummy_obs).shape[1:])
        self.world_action_shape = tuple(self.tr.env_action_to_world(dummy_act).shape[1:])

        # Surrogate ensemble + the members' stacked trainer state, whose
        # parameters are the ensemble's.
        delta = self.env.delta
        model_kwargs = {**self.env.scenario, **cfg.model}
        self.loss_fn = make_loss(cfg.loss, self.env.scenario)
        self.tau = cfg.training.get("tau", 5)
        self.ensemble: EnsembleState = init_ensemble(
            lambda: factories.make(cfg.factory, delta=delta, **model_kwargs),
            cfg.num_dynamics_models, cfg.num_elite_models, device=dev,
        )
        self.train_cfgs = {
            phase: self._phase_train_config(phase) for phase in ("initial", "iterations")
        }
        self.trainer = SurrogateTrainer(self.loss_fn, self.train_cfgs["initial"],
                                        check=self.finite)
        self.trainer.mesh = self.mesh
        self.fit_state = self.trainer.init_members(self.ensemble.members,
                                                   self.ensemble.params)

        # Replays.
        ep_len = self.env.max_episode_steps
        rows = max(cfg.capacity // ep_len, cfg.num_envs + 2)
        self.replay = R.create(rows, ep_len, cfg.num_envs, self.env.obs_shape,
                               self.env.action_shape, self.env.dtype, device=dev)
        h_max = self._max_horizon()
        w_rows = min(
            cfg.model_buffer_store_iterations
            * cfg.model_rollouts_per_sample
            * self.samples_per_iteration,
            max(cfg.model_buffer_max_capacity // max(h_max, 1), 1),
        )
        w_rows = max(w_rows, cfg.model_rollouts_batch_size + 2)
        self.world_replay = R.create(
            w_rows, h_max + 2, cfg.model_rollouts_batch_size,
            self.world_obs_shape, self.env.action_shape, self.env.dtype, device=dev,
        )

        # SAC agent.
        sac_cfg = SACConfig(
            gamma=cfg.gamma, tau=cfg.sac_tau, alpha=cfg.alpha, lr=cfg.lr,
            hidden=cfg.hidden_size,
            target_update_interval=cfg.target_update_interval,
            automatic_entropy_tuning=cfg.automatic_entropy_tuning,
            reward_scale=cfg.reward_scale,
        )
        self.sac = SAC(self.agent_obs_shape, self.env.action_shape, sac_cfg,
                       self.env.action_low, self.env.action_high, device=dev,
                       check=self.finite, mesh=self.mesh)
        self.sac_state = self.sac.init()
        self.random_agent = RandomAgent(self.env.action_shape, self.env.action_low,
                                        self.env.action_high)

        self.world = WorldModel(cfg.model_rollouts_batch_size,
                                self.env.max_episode_steps, self.env.reward_fn,
                                self.tau, mesh=self.mesh)

        # Collect env state; the initial reset updates the running obs
        # scaling (vec_wrappers.py:181-184).  A rank keeps its envs.
        self.env_state = self.env.reset_from_pool(self.gen, self.pool, (cfg.num_envs,))
        self.tr = self.tr.replace(
            oscaling=self.tr.oscaling.update(self.env.observe(self.env_state))
        )
        if self.mesh is not None:
            self.env_state = self.env_state.replace(
                u=self.env_state.u[self.env_rows].clone(),
                step=self.env_state.step[self.env_rows].clone())

        # Plot renders and npz writes run on one background thread, drained
        # at the end of learn().
        self.viz = BackgroundRenderer(enabled=self.primary)
        self.last_trace: Dict = {}  # --profile_dir's trace: path, wall_s, export_s
        self._start_time = time.time()
        self.throughput = profiling.Throughput()
        self.gc_monitor = profiling.GCMonitor()
        # The graphs of the fused iteration, the phases and the fit on the
        # card, the record awaiting its pull, and whether an iteration ran
        # eagerly in this process (which a capture of the fused iteration
        # needs first: it loads every kernel and sets up every library
        # handle and optimizer state the body touches).
        # The routes share one cache, and so one memory pool.
        cache = GraphCache([self.gen]) if dev.type == "cuda" and graphs else None
        self.graphs = cache if self.routes["phases"] else None
        self.trainer.fuse_fit = cfg.fuse_fit and self.routes["fit"]
        self.trainer.graphs = cache if self.trainer.fuse_fit else None
        self._capture_log: Dict[str, float] = {}
        self._pending_log = None
        # surrogate_rollout's replay row and start, written before each call.
        self._sur_index = torch.zeros((2,), dtype=torch.int64, device=dev)
        self._warm = False

        # Checkpoint / resume.
        self.ckpt = None
        self.restored = False
        if cfg.checkpoint_freq or cfg.resume:
            self.ckpt = C.CheckpointManager(os.path.join(cfg.run_dir, "checkpoints"))
            if self.mesh is not None:
                self.mesh.barrier()  # every rank reads the same snapshot
            if cfg.resume and self.ckpt.latest_step() is not None:
                C.load_controller_state(self, self.ckpt.restore(map_location=dev))
                self.restored = True
                print(f"[resume] restored iteration {self.iteration}", flush=True)

        # The metrics sink is created LAST, so that append mode tracks whether
        # a checkpoint was actually restored: --resume with nothing to restore
        # starts a fresh stream (the logger backs the old one up) instead of
        # appending a restarted run onto it.
        self.logger = logger or MetricsLogger(config.run_dir, False, config.project,
                                              config.name, config.to_dict(),
                                              append=self.restored, enabled=self.primary)

    # ------------------------------------------------------------- plumbing
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _phase_train_config(self, phase: str) -> TrainConfig:
        cfg = self.config
        base = {k: v for k, v in cfg.training.items()
                if k not in ("initial", "iterations")}
        base.update(cfg.training.get(phase, {}))
        trainer_base = {k: v for k, v in cfg.trainer.items()
                        if k not in ("initial", "iterations")}
        trainer_base.update(cfg.trainer.get(phase, {}))
        merged = {**base, **trainer_base}
        return TrainConfig(**{k: v for k, v in merged.items() if k in TrainConfig._fields})

    def _max_horizon(self) -> int:
        h = 1
        total_iters = max(
            int(self.config.total_timesteps / max(self.samples_per_iteration, 1)), 1
        )
        for it in (0, total_iters // 2, total_iters):
            h = max(h, int(self.schedule(iteration=it)))
        return h

    @property
    def num_world_rollouts(self) -> int:
        return int(self.config.model_rollouts_per_sample * self.samples_per_iteration)

    @property
    def world_rounds(self) -> int:
        return max(math.ceil(self.num_world_rollouts
                             / self.config.model_rollouts_batch_size), 1)

    @property
    def num_steps_sampled(self) -> int:
        return self.iteration * self.samples_per_iteration

    # ------------------------------------------------------------ collection
    def _data(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Per-env tensors of the whole batch: under a mesh, this rank's rows
        gathered over ``data``; else the tensors themselves."""
        if self.mesh is None:
            return tensors
        return tuple(self.mesh.gather(tensors, meshlib.DATA_AXIS))

    def collect(self, nsteps: int, random: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (per-step rewards [nsteps, B], their mean); the env state
        and the obs scaling are updated in place.  Under a mesh a rank steps
        its envs, and the actions, the replay writes and the scaling see the
        whole batch.  The random warmup runs eagerly; the policy's steps
        replay a graph on the card."""
        if random:
            return self._collect_body(nsteps, random)
        return self._phase(("collect", nsteps, random), "collect",
                           lambda: self._collect_body(nsteps, random),
                           lambda: tensors_of(self.env_state, self.tr, self.pool, self.replay,
                                              self.sac_state.policy))

    @torch.no_grad()
    def _collect_body(self, nsteps: int, random: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        env, tr, state = self.env, self.tr, self.env_state
        rewards = []
        (raw_obs,) = self._data(env.observe(state))
        for _ in range(nsteps):
            if random:
                action = self.random_agent.select_action(None, raw_obs, self.gen)
            else:
                action = self.sac.select_action(
                    self.sac_state, tr.raw_to_agent_obs(raw_obs), self.gen)
            env_action = tr.agent_to_env_action(action)
            if self.mesh is None:
                state, out = env.vec_step(state, env_action, self.pool)
            else:
                state, out = sharded_vec_step(self.mesh, env, state,
                                              env_action[self.env_rows], self.pool)
            if self.finite is not None:
                self.finite("collect (env step)", field=out.info["final_obs"],
                            reward=out.reward)
            # Update-then-apply ordering: the next step reads obs through the
            # updated scaling (vec_wrappers.py:157-160); running min/max
            # updates are idempotent, so the extra finals update is exact.
            tr = tr.replace(oscaling=tr.oscaling.update(out.obs)
                            .update(out.info["final_obs"]))
            R.write_step(self.replay, raw_obs, env_action, out.reward,
                         out.terminated, out.truncated, out.info["final_obs"],
                         out.info["step"])
            rewards.append(out.reward)
            raw_obs = out.obs
        copy_into(self.env_state, state)
        copy_into(self.tr.oscaling, tr.oscaling)
        rewards = torch.stack(rewards)
        return rewards, torch.mean(rewards)

    # ------------------------------------------------------ surrogate train
    @torch.no_grad()
    def update_delta_transform(self) -> None:
        """Refit the delta Normalize over the whole replay (mbrl.py:597-602)."""
        otransf = self.tr.replay_to_world.otransf
        mean, var = R.delta_statistics(self.replay, otransf, self.env.delta)
        und = self.tr.undscaling.reset()
        und = und.replace(
            mean=und.mean + mean.to(und.mean.dtype),
            var=und.var + var.to(und.var.dtype),
            count=und.count + 1,
        )
        copy_into(self.tr.undscaling, und)

    def update_surrogates(self) -> Dict[str, float]:
        cfg = self.config
        phase = "initial" if self.iteration <= 0 else "iterations"
        tc = self.train_cfgs[phase]
        self.trainer.config = tc
        t_split0 = time.perf_counter()

        # Train/val split over episodes with any data (mbrl.py:570-573).  The
        # val split must hold at least one window at the fit's starting
        # length; short in-progress episodes stay in train.
        fill = self.replay.fill.cpu().numpy()
        rows = np.where(fill > 0)[0]
        rng = np.random.default_rng(self.iteration)
        rng.shuffle(rows)
        gsteps = self.fit_state.global_step.tolist()
        start_step = max(gsteps)
        length0 = tc.tau + int(self.curriculum(iteration=self.iteration, epoch=0,
                                               step=start_step))
        ok = rows[fill[rows] >= length0]
        short = rows[fill[rows] < length0]
        if len(ok) == 0:
            raise ValueError(
                f"no episode long enough for a length-{length0} window "
                f"(fills={fill[rows].tolist()})"
            )
        if len(ok) == 1:
            # The single trainable episode serves both splits.
            val_rows = ok
            train_rows = np.concatenate([ok, short])
        else:
            n_val = max(int(len(rows) * cfg.val_split_ratio), 1)
            n_val = min(n_val, len(ok) - 1)
            val_rows = ok[:n_val]
            train_rows = np.concatenate([ok[n_val:], short])
        train_np = np.zeros((self.replay.num_rows,), bool)
        train_np[train_rows] = True
        val_np = np.zeros((self.replay.num_rows,), bool)
        val_np[val_rows] = True
        train_mask = torch.as_tensor(train_np, device=self.device)
        val_mask = torch.as_tensor(val_np, device=self.device)
        t_split = time.perf_counter() - t_split0

        fit_args = (self.replay, train_mask, val_mask, self.tr.undscaling,
                    self.tr.replay_to_world, self.curriculum, self.iteration, self.gen)
        hints = {"fill": fill, "train_np": train_np, "val_np": val_np}
        t_fit0 = time.perf_counter()
        if cfg.vmap_ensemble_training:
            # All members in lock-step, each with its own early stopping.
            self.fit_state, scores, logs = self.trainer.fit_ensemble(
                self.fit_state, *fit_args, min_steps=tc.min_steps,
                max_steps=tc.max_steps, patience=tc.patience,
                host_hints={**hints, "start_step": start_step})
            scores = [float(s) for s in scores]
        else:
            # One member after another; the record carries the last
            # member's fit logs, as the JAX package's does, and the timers
            # of all of them.
            scores, timers = [], {"t_fit_train": 0.0, "t_fit_val": 0.0}
            captures = {"t_fit_capture": 0.0, "fit_graph_pool_mb": 0.0}
            for i in range(self.fit_state.num_members):
                _, val_loss, logs = self.trainer.fit(
                    self.fit_state.member(i), *fit_args, min_steps=tc.min_steps,
                    max_steps=tc.max_steps, patience=tc.patience,
                    host_hints={**hints, "start_step": gsteps[i]})
                scores.append(val_loss)
                for k in timers:
                    timers[k] += logs[k]
                for k in captures:
                    captures[k] += logs.get(k, 0.0)
            logs.update({k: round(v, 4) for k, v in timers.items()})
            # The members share the one-member fit's graphs.
            logs.update({k: round(v, 4) for k, v in captures.items() if v})
        logs["t_fit_total"] = round(time.perf_counter() - t_fit0, 4)
        t_post0 = time.perf_counter()
        self.ensemble.elite_mask.copy_(update_elites(
            self.ensemble, torch.as_tensor(scores, device=self.device)).elite_mask)
        self.num_ensemble_updates += 1
        self._train_vis(train_mask, val_mask, length0)
        return {"val_loss": float(np.mean(scores)), **logs,
                "elite_scores": scores,
                "t_split": round(t_split, 4),
                "t_post": round(time.perf_counter() - t_post0, 4)}

    @torch.no_grad()
    def _train_vis(self, train_mask: torch.Tensor, val_mask: torch.Tensor,
                   length: int) -> None:
        """Train-time plots (reference VisCallback, callbacks.py:13-81):
        after a surrogate retrain, at the ``logging_freq`` cadence, one
        random train window and one random val window against member 0's
        free-run reconstruction: the PDE comparison panels and the delta
        heatmaps.  The draws and the rollout happen here whether or not the
        host can render, so the generator's stream does not depend on the
        host's packages."""
        cfg = self.config
        if cfg.logging_freq <= 0 or (self.num_ensemble_updates - 1) % cfg.logging_freq:
            return
        d = os.path.join(cfg.run_dir, "plots")
        iteration = self.iteration
        member, tau = self.ensemble.members[0], self.trainer.config.tau
        stransf, und = self.tr.replay_to_world, self.tr.undscaling
        for stage, mask in (("train", train_mask), ("val", val_mask)):
            batch = stransf(R.sample_windows(self.replay, self.gen, 4, length,
                                             rows_mask=mask))
            states, actions = batch.obs, batch.actions
            roll = member.rollout(states[:, :tau], actions, dscaling=und.inv)
            decoded = torch.cat([states[:, :1], roll.outputs[:, :-1]], dim=1)
            # A random sequence of the batch (callbacks.py:62), unscaled to
            # physical space before plotting (callbacks.py:67-72).
            i = int(torch.randint(0, states.shape[0], (1,), generator=self.gen,
                                  device=self.device))
            obs = _to_numpy(stransf.otransf.inverse(states[i]))
            opred = _to_numpy(stransf.otransf.inverse(decoded[i]))
            acts = _to_numpy(stransf.atransf.inverse(actions[i]))

            def job(stage=stage, obs=obs, opred=opred, acts=acts):
                from pdecontrol_tpu_torch.viz import plots

                os.makedirs(d, exist_ok=True)
                plots.pdeplot(obs, opred, acts).save(
                    os.path.join(d, f"{stage}_vis_iter{iteration}.png"))
                plots.spatial({
                    "deltas": np.diff(obs, axis=0),
                    "outdeltas": np.diff(opred, axis=0),
                }).save(os.path.join(d, f"{stage}_spatial_iter{iteration}.png"))

            self.viz.submit(job)

    # -------------------------------------------------------- world rollouts
    def imagine(self, horizon: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Imagined rollouts in batches of ``model_rollouts_batch_size`` from
        replay starting states; returns (rewards [rounds*horizon, B], mean).
        Each round starts from a reset, so the state after its last step is
        not needed and the world step draws no reset there.  Under a mesh a
        rank rolls out its share of the batch, and the actions and the
        replay writes see the whole batch."""
        return self._phase(("world", horizon, self.world_rounds), "imagine",
                           lambda: self._imagine_body(horizon),
                           lambda: tensors_of(self.tr, self.replay, self.world_replay,
                                              self.ensemble, self.sac_state.policy))

    @torch.no_grad()
    def _imagine_body(self, horizon: int) -> Tuple[torch.Tensor, torch.Tensor]:
        tr, world, ens = self.tr, self.world, self.ensemble
        rows = slice(None) if world.rows is None else world.rows
        rewards = []
        for _ in range(self.world_rounds):
            wstate = world.reset(self.gen, ens, self.replay, tr)
            obs, t = self._data(wstate.obs, wstate.timesteps)
            for k in range(horizon):
                prev_obs, prev_t = obs, t
                action = self.sac.select_action(
                    self.sac_state, tr.world_to_agent_obs(prev_obs), self.gen)
                wstate, (_, reward, term, trunc, final_obs) = world.step(
                    self.gen, wstate, ens, action[rows], tr, horizon, self.replay,
                    reset=k < horizon - 1)
                if self.finite is not None:
                    self.finite("imagine (world-model step)", obs=final_obs,
                                reward=reward)
                obs, t, reward, term, trunc, final_obs = self._data(
                    wstate.obs, wstate.timesteps, reward, term, trunc, final_obs)
                R.write_step(self.world_replay, prev_obs, action, reward, term,
                             trunc, final_obs, prev_t + 1)
                rewards.append(reward)
        rewards = torch.stack(rewards)
        return rewards, torch.mean(rewards)

    # --------------------------------------------------------- policy update
    def update_policy(self) -> Dict[str, torch.Tensor]:
        """``num_pol_updates_per_iteration`` SAC updates on mixed batches;
        returns the last update's metrics.  A graph holds the pattern of
        target updates of the chain it captured, so where the chain's length
        is not a multiple of ``target_update_interval`` the chain's offset
        keys it too."""
        n = self.num_pol_updates_per_iteration
        interval = self.config.target_update_interval
        key = ("policy", n) + ((self.sac_state.updates % interval,) if n % interval else ())
        return self._phase(key, "update_policy", self._policy_body,
                           lambda: tensors_of(self.tr, self.replay, self.world_replay,
                                              self.sac_state))

    def _policy_body(self) -> Dict[str, torch.Tensor]:
        n = self.num_pol_updates_per_iteration
        bs = self.config.policy_batch_size
        tr = self.tr
        w_n = self.world_replay.ntimesteps.to(torch.float32)
        p_imag = w_n / torch.clamp(w_n + self.replay.ntimesteps, min=1)
        @torch.no_grad()
        def mixed_batch() -> Sample:
            real = tr.replay_to_agent(R.sample_transitions(self.replay, self.gen, bs))
            imag = tr.world_replay_to_agent(
                R.sample_transitions(self.world_replay, self.gen, bs))
            pick = torch.rand((bs,), generator=self.gen, device=self.device) < p_imag

            def sel(a, b):
                return torch.where(pick.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

            batch = Sample(*(sel(a, b) for a, b in zip(imag, real)))
            if self.mesh is not None:  # this rank's share
                batch = batch.apply(lambda x: x[self.mesh.data_slice(bs)])
            return batch.replace(
                obs=batch.obs.float(), actions=batch.actions.float(),
                nxtobs=batch.nxtobs.float(), rewards=batch.rewards.float(),
            )

        # Each batch is drawn just before its update, as in the reference loop.
        self.sac_state, metrics = self.sac.update_many(
            self.sac_state, (mixed_batch() for _ in range(n)), self.gen)
        self.num_pol_updates += n
        return metrics

    # ------------------------------------------------------------ evaluation
    @torch.no_grad()
    def evaluate_policy(self) -> Dict[str, float]:
        """Deterministic episodes on fresh envs with frozen scaling
        (mbrl.py:462-465); the episodes' trajectories go to an npz artifact
        (mbrl.py:467-472)."""
        n, steps = self.config.num_eval_episodes, self.env.max_episode_steps
        obs, actions, rewards, stats = self._phase(
            ("eval", steps, n), "evaluate_policy", lambda: self._eval_body(n, steps),
            lambda: tensors_of(self.tr, self.pool, self.sac_state.policy))
        self._save_eval_artifact(obs, actions, rewards)
        mean, std = stats.tolist()
        return {"eval_return_mean": mean, "eval_return_std": std}

    @torch.no_grad()
    def _eval_body(self, n: int, steps: int) -> Tuple[torch.Tensor, ...]:
        """The evaluation's episodes: (obs [T, n, ...], env actions, rewards
        [T, n], and the returns' mean and std)."""
        env, tr = self.env, self.tr
        state = env.reset_from_pool(self.gen, self.pool, (n,))
        obs_seq, actions, rewards = [], [], []
        for _ in range(steps):
            raw = env.observe(state)
            action = self.sac.select_action(self.sac_state, tr.raw_to_agent_obs(raw),
                                            self.gen, deterministic=True)
            env_action = tr.agent_to_env_action(action)
            state, out = env.step(state, env_action)
            obs_seq.append(raw)
            actions.append(env_action)
            rewards.append(out.reward)
        rewards = torch.stack(rewards)
        returns = rewards.sum(0)
        return (torch.stack(obs_seq), torch.stack(actions), rewards,
                torch.stack([returns.mean(), returns.std(correction=0)]))

    @torch.no_grad()
    def surrogate_rollout(self, row, start, horizon: int) -> Dict[str, torch.Tensor]:
        """Open-loop rollout of the logged actions of replay row ``row`` from
        step ``start`` (the JAX package's ``_sur_eval_fn``, which takes both
        traced): a tau-step teacher-forced warm start (mbrl.py:484-496),
        then the episode's own actions for ``horizon`` steps
        (``ActionRepeatAgent``, mbrl.py:498-506).  ``row`` and ``start`` are
        0-d integer tensors on the controller's device (or ints).  Returns
        ``err`` (MSE in world space), ``hstep`` (the MSE per horizon step),
        ``reward_err`` (imagined-vs-true reward L1 error), ``truth`` and
        ``preds`` [h, C, Hw], the world-space ``actions`` and the reward
        curves ``rtrue`` and ``rpred``."""
        tau, tr, world, rp = self.tau, self.tr, self.world, self.replay
        # A 1-element index: indexing by a 0-d tensor reads it on the host.
        row = torch.as_tensor(row, device=self.device).reshape(1)
        idx = torch.as_tensor(start, device=self.device) + torch.arange(
            tau + horizon, device=self.device)
        sample = Sample(
            obs=rp.obs_seq[row, idx][None],
            actions=rp.actions[row, idx][None],
            nxtobs=rp.obs_seq[row, idx + 1][None],
            rewards=rp.rewards[row, idx][None],
            terminated=rp.terminated[row, idx][None],
            truncated=rp.truncated[row, idx][None],
            steps=rp.steps[row, idx][None],
        )
        wsample = tr.replay_to_world(sample)
        state = world.reset_from_batch(self.gen, self.ensemble,
                                       wsample.apply(lambda x: x[:, :tau]), tr)
        agent = ActionRepeatAgent(tr.env_action_to_agent(sample.actions))
        preds, rpred = [], []
        for t in range(tau, tau + horizon):
            waction = tr.env_action_to_world(tr.agent_to_env_action(agent.action_at(t)))
            # The PRE-advance obs: prediction i is the model's frame tau+i
            # (mbrl.py:508-517).
            preds.append(state.obs[0])
            state, reward = world.advance(self.gen, state, self.ensemble, waction, tr)
            rpred.append(reward[0])
        preds, rpred = torch.stack(preds), torch.stack(rpred)
        truth = wsample.obs[0, tau:]
        sq = (preds - truth) ** 2
        rtrue = sample.rewards[0, tau:]
        return {
            "err": torch.mean(sq),
            "hstep": torch.mean(sq, dim=(1, 2)),
            "reward_err": torch.mean(torch.abs(rpred - rtrue)),
            "truth": truth,
            "preds": preds,
            "actions": wsample.actions[0, tau:],
            "rtrue": rtrue,
            "rpred": rpred,
        }

    def evaluate_surrogate(self, horizon: Optional[int] = None) -> Dict[str, float]:
        """Open-loop replay of one logged episode's actions through the world
        model vs the logged truth (mbrl.py:474-527): a random completed
        episode and a random start, then ``surrogate_rollout``.  Scores the
        MSE in world space and the imagined-vs-true reward L1 error, and
        hands the curves to the plots and the npz artifact."""
        horizon = self.config.surrogate_eval_horizon if horizon is None else horizon
        tau = self.tau
        u = torch.rand((2,), generator=self.gen, device=self.device).cpu().numpy()
        fill = self.replay.fill.cpu().numpy()
        complete = self.replay.complete.cpu().numpy()
        rows = np.where(complete & (fill >= tau + horizon))[0]
        if len(rows) == 0:
            return {}
        row = int(rows[min(int(u[0] * len(rows)), len(rows) - 1)])
        # Exclusive upper bound as the reference's
        # np.random.randint(0, length - tau - horizon) (mbrl.py:485).
        hi = max(int(fill[row]) - tau - horizon, 1)
        start = min(int(u[1] * hi), hi - 1)

        index = self._sur_index
        index.copy_(torch.tensor([row, start], dtype=index.dtype))
        out = self._phase(("sur_eval", horizon), "surrogate_rollout",
                          lambda: self.surrogate_rollout(index[0], index[1], horizon),
                          lambda: tensors_of(self.tr, self.replay, self.ensemble, index))
        out = {k: _to_numpy(v) for k, v in out.items()}
        self._save_plots(out)
        self._save_surrogate_artifact(out)
        return {"surrogate_open_loop_mse": float(out["err"]),
                "reward_model_error": float(out["reward_err"])}

    # ---------------------------------------------------- plots and artifacts
    # The tensors reach the host on the main thread, before a job is queued;
    # the worker renders and writes.  All of it is off at logging_freq <= 0.
    def _save_plots(self, out: Dict[str, np.ndarray]) -> None:
        """The open-loop comparison plots (reference VisPDECallback /
        evaluate_surrogate pdeplot, mbrl.py:519-527) with the reward curves
        (VisRewardDiff, mbrl/callbacks.py:72-106), and the h-step curve."""
        if self.config.logging_freq <= 0:
            return
        d = os.path.join(self.config.run_dir, "plots")
        iteration = self.iteration

        def job():
            from pdecontrol_tpu_torch.viz import plots

            os.makedirs(d, exist_ok=True)
            plots.pdeplot(out["truth"], out["preds"], out["actions"],
                          rewards=out["rtrue"], rpred=out["rpred"]).save(
                os.path.join(d, f"surrogate_iter{iteration}.png"))
            plots.hstepplot(out["hstep"]).save(
                os.path.join(d, f"hstep_iter{iteration}.png"))

        self.viz.submit(job)

    def _save_surrogate_artifact(self, out: Dict[str, np.ndarray]) -> None:
        """Per-eval h-step battery artifact (reference EvalLogCallback,
        callbacks.py:102-134): ground truth, open-loop predictions, actions,
        reward curves and the h-step loss curve as one npz."""
        if self.config.logging_freq <= 0:
            return
        d = os.path.join(self.config.run_dir, "evaluation")
        iteration = self.iteration

        def job():
            os.makedirs(d, exist_ok=True)
            np.savez_compressed(
                os.path.join(d, f"surrogate_eval_{iteration}.npz"),
                states=out["truth"], outputs=out["preds"], actions=out["actions"],
                rewards=out["rtrue"], rpred=out["rpred"], hstep_mse=out["hstep"],
            )

        self.viz.submit(job)

    def _save_eval_artifact(self, obs: torch.Tensor, actions: torch.Tensor,
                            rewards: torch.Tensor) -> None:
        """Eval-episode trajectories as an npz artifact (mbrl.py:467-472),
        [T, B, ...] -> [B, T, ...]: episode-major like the reference dataset."""
        if self.config.logging_freq <= 0:
            return
        d = os.path.join(self.config.run_dir, "evaluation")
        iteration = self.iteration
        arrays = {
            "obs": _to_numpy(obs),
            "actions": _to_numpy(actions),
            "rewards": _to_numpy(rewards),
        }

        def job():
            os.makedirs(d, exist_ok=True)
            np.savez_compressed(os.path.join(d, f"eval_{iteration}.npz"),
                                **{k: np.swapaxes(v, 0, 1) for k, v in arrays.items()})

        self.viz.submit(job)

    # ------------------------------------------------------------------ main
    def learn(self) -> None:
        cfg = self.config
        self.logger.log({"start": self._start_time}, commit=False)
        if self.finite is not None:
            self.finite.iteration = self.iteration

        if not self.restored:
            # Random warmup (mbrl.py:388-391).  A restored replay already
            # holds it, and the restored generator is past it.
            t0 = time.perf_counter()
            warmup_steps = max(cfg.learning_starts // cfg.num_envs, 1)
            self.collect(warmup_steps, random=True)
            self._sync()
            t_warmup = time.perf_counter() - t0
            t0 = time.perf_counter()
            self.logger.log(self.evaluate_policy(), commit=False)
            self.logger.log(
                {"t_warmup_collect": round(t_warmup, 4),
                 "t_warmup_eval": round(time.perf_counter() - t0, 4)},
                commit=False,
            )

        saved_at = self.iteration if self.restored else None
        while self.num_steps_sampled < cfg.total_timesteps - cfg.learning_starts:
            # A profiler trace of one representative iteration (the primary
            # rank's); a graph it replays is captured before the trace starts.
            traced = bool(cfg.profile_dir) and self.iteration == 1 and self.primary
            if traced:
                self._prepare_graph()
            with (profiling.trace(cfg.profile_dir) if traced
                  else contextlib.nullcontext()) as trace:
                self._run_iteration()
            if traced:
                self.last_trace = trace
                print(f"[profile] trace of iteration 1 ({trace['wall_s']:.2f} s) written "
                      f"to {trace['path']} (export {trace['export_s']:.1f} s)", flush=True)

            if self.primary and self.iteration % cfg.status_report_freq == 0:
                print(self.logger.table(STATUS_HEADERS), flush=True)

            if self.ckpt is not None and cfg.checkpoint_freq and (
                self.iteration % cfg.checkpoint_freq == 0
            ):
                self.save_checkpoint()
                saved_at = self.iteration

        self._flush_pending_log()
        # One more snapshot at the end, unless the last iteration left one.
        if self.ckpt is not None and cfg.checkpoint_freq and saved_at != self.iteration:
            self.save_checkpoint()
        if self.ckpt is not None:
            self.ckpt.wait()  # the files must be on disk before exit
        self.viz.drain()  # and so must the plots and artifacts
        if self.mesh is not None:
            self.mesh.barrier()  # on every rank's return, the primary's files are written

    def save_checkpoint(self) -> None:
        """Snapshot the training state at ``self.iteration``; returns once the
        state is copied to host memory (the file is written behind it).  The
        record still awaiting its pull is committed first.  Under a mesh
        every rank takes part in gathering the envs, and the primary
        writes."""
        self._flush_pending_log()
        self._sync()
        state = C.controller_state(self)
        if self.mesh is not None:
            state = C.replicate_for_snapshot(state, self.mesh)
        if self.primary:
            self.ckpt.save(self.iteration, state)

    # ---------------------------------------------------- the fused iteration
    def _fused_key(self) -> Optional[Tuple[int, int, int, int]]:
        """This iteration's graph key, the JAX package's ``_fused_jit`` key
        (rollout length, horizon, rounds, SAC updates), or None if the
        iteration runs its phases eagerly."""
        if not self.fused or self.iteration % self.sur_train_freq == 0:
            return None
        return (self.config.rollout_length, int(self.schedule(iteration=self.iteration)),
                self.world_rounds, self.num_pol_updates_per_iteration)

    def _fused_body(self, nsteps: int, horizon: int) -> torch.Tensor:
        """One non-retrain iteration: collect -> imagined rollouts -> chained
        SAC updates, and the packed log scalars (the JAX package's
        ``_fused_iteration_fn``).  It changes the controller's state only in
        place, so that a CUDA graph of it replays onto the same tensors."""
        self._fused_phase = "collect"
        _, collect_rmean = self._collect_body(nsteps, False)
        self._fused_phase = "imagine"
        _, imag_rmean = self._imagine_body(horizon)
        self._fused_phase = "policy"
        metrics = self._policy_body()
        self._fused_phase = "pack"
        return self._pack_scalars(collect_rmean, imag_rmean, metrics)

    def _pack_scalars(self, collect_rmean, imag_rmean, metrics) -> torch.Tensor:
        """The ``LOG_SCALARS`` as one float64 vector, pulled in one copy."""
        return torch.stack([
            self.world_replay.ntimesteps.double(), collect_rmean.double(),
            imag_rmean.double(), metrics["qf_loss"].double(),
            metrics["policy_loss"].double(), self.replay.total_steps.double(),
        ])

    def _graph_state(self):
        """The tensors the fused body reads and writes."""
        return tensors_of(self.env_state, self.tr, self.pool, self.replay,
                          self.world_replay, self.ensemble, self.sac_state)

    def _phase(self, key, what: str, body, state):
        """A phase's ``body``, eagerly, or on the card through its CUDA graph
        under ``key`` (``GraphCache.run``: the first call of a key runs
        eagerly and captures after it; a replay returns a copy of the
        graph's output, which outlives the other graphs' replays).
        ``state`` gives the tensors the body reads and writes."""
        if self.graphs is None:
            return body()
        captured = []
        out = self.graphs.run(
            key, body, state, f"the {what} phase",
            counters=((self, "num_pol_updates"), (self.sac_state, "updates")),
            captured=captured)
        for graph in captured:
            self._note_capture(f"the {what} phase {key}", graph)
        return out

    def _note_capture(self, what: str, graph) -> None:
        """Add a capture to the next record's ``t_capture`` and
        ``graph_pool_mb``."""
        log = self._capture_log
        log["t_capture"] = round(log.get("t_capture", 0.0) + graph.seconds, 4)
        log["graph_pool_mb"] = round(log.get("graph_pool_mb", 0.0) + graph.pool_bytes / 1e6, 3)
        print(f"[graphs] captured {what} in {graph.seconds:.2f} s; the shared pool grew "
              f"by {graph.pool_bytes / 1e6:.1f} MB", flush=True)

    def _prepare_graph(self) -> None:
        """Capture this iteration's graph if it replays one not yet captured.
        A capture runs the body's host code once and launches nothing: the
        host counters it advanced are put back, and each replay advances
        them.  No eager call of the key comes first: an earlier eager
        iteration (``_warm``) loaded what the body touches, and under a mesh
        ``make_mesh`` made every group's communicator."""
        key = self._fused_key()
        if (key is None or self.graphs is None or not self._warm
                or self.graphs.get(key) is not None):
            return
        counters = (self.num_pol_updates, self.sac_state.updates)
        self._fused_phase = None
        try:
            graph = self.graphs.capture(key, lambda: self._fused_body(key[0], key[1]),
                                        self._graph_state())
        except Exception as e:
            raise RuntimeError(f"capturing the fused iteration {key} as a CUDA graph "
                               f"failed{on_rank()} in its {self._fused_phase} phase: "
                               f"{e}") from e
        finally:
            self.num_pol_updates, self.sac_state.updates = counters
        self._note_capture(f"the fused iteration {key}", graph)

    def _dispatch(self, key) -> torch.Tensor:
        """Run this iteration's fused body: replay its graph on the card, or
        run it eagerly on the CPU and for the warm-up before the first
        capture.  Returns the packed log scalars."""
        graph = self.graphs.get(key) if self.graphs is not None else None
        if graph is None:
            packed = self._fused_body(key[0], key[1])
        else:
            try:
                packed = graph.replay(self._graph_state())
            except Exception as e:
                raise RuntimeError(f"replaying the fused iteration {key} "
                                   f"failed{on_rank()}: {e}") from e
            self.num_pol_updates += key[3]
            self.sac_state.updates += key[3]
        self._warm = True
        return packed

    @staticmethod
    def _start_pull(packed: torch.Tensor):
        """Queue the packed scalars' copy to the host behind the work that
        computes them; ``_finish_pull`` waits for it.  On the card a replay
        rewrites the graph's output, so the copy must leave before the next."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    @staticmethod
    def _finish_pull(pull) -> Dict[str, float]:
        host, copied = pull
        if copied is not None:
            copied.synchronize()
        return dict(zip(LOG_SCALARS, host.tolist()))

    def _commit_record(self, rec: Dict, pulled: Dict[str, float]) -> None:
        rec = dict(rec)
        rec.update({
            "world_buffer_samples": int(pulled["world_buffer_samples"]),
            "collect_reward_mean": float(pulled["collect_reward_mean"]),
            "imagined_reward_mean": float(pulled["imagined_reward_mean"]),
            "sac_qf_loss": float(pulled["sac_qf_loss"]),
            "sac_policy_loss": float(pulled["sac_policy_loss"]),
            "env_steps_per_sec": self.throughput.update(int(pulled["total_steps"])),
        })
        self.logger.log(rec, commit=True)

    def _flush_pending_log(self) -> None:
        """Pull and commit the previous fused iteration's record.  Called
        one iteration behind (its copy was queued behind its work, which the
        host did not wait for), and before anything that must see a complete
        metrics stream: an evaluation or retrain iteration, a checkpoint, the
        end of ``learn()``."""
        if self._pending_log is None:
            return
        rec, pull, t0 = self._pending_log
        self._pending_log = None
        pulled = self._finish_pull(pull)
        # Dispatch -> results on the host: it spans the next iteration's
        # dispatch, so it bounds the device time from above.
        rec["t_ready"] = round(time.perf_counter() - t0, 4)
        self._commit_record(rec, pulled)

    def _run_iteration(self) -> None:
        cfg = self.config
        if self.finite is not None:
            self.finite.iteration = self.iteration
        retrain = self.iteration % self.sur_train_freq == 0
        eval_iter = self.iteration % cfg.agent_eval_freq == 0
        horizon = int(self.schedule(iteration=self.iteration))
        key = self._fused_key()
        self._prepare_graph()
        timings: Dict[str, float] = {}
        t = time.perf_counter()

        if key is not None:
            pull = self._start_pull(self._dispatch(key))
            timings["t_dispatch"] = round(time.perf_counter() - t, 4)
            if not eval_iter:
                # Pipelined: this record waits for its pull, the previous
                # one is committed now.
                rec = {
                    "iteration": self.iteration,
                    "num_steps_sampled": self.num_steps_sampled + cfg.learning_starts,
                    "horizon": horizon,
                    "num_pol_updates": self.num_pol_updates,
                    **timings,
                    **self._take_captures(),
                    "time": time.time() - self._start_time,
                }
                self._flush_pending_log()
                self._pending_log = (rec, pull, time.perf_counter())
                self.iteration += 1
                return
            self._flush_pending_log()
            pulled = self._finish_pull(pull)
            timings["t_fused"], t = round(time.perf_counter() - t, 4), time.perf_counter()
        else:
            self._flush_pending_log()

            def lap(name: str, t: float) -> float:
                # Under fuse_iteration a retrain does not wait at each phase.
                if not self.fused:
                    self._sync()
                now = time.perf_counter()
                timings[name] = round(now - t, 4)
                return now

            _, collect_rmean = self.collect(cfg.rollout_length, random=False)
            t = lap("t_collect", t)

            if retrain:
                self.gc_monitor.drain()  # reset the window to this retrain
                t_delta0 = time.perf_counter()
                self.update_delta_transform()
                t_delta = time.perf_counter() - t_delta0
                logs = self.update_surrogates()
                gc_pause, gc_max, gc_counts = self.gc_monitor.drain()
                self.logger.log(
                    {"num_ensemble_updates": self.num_ensemble_updates, **logs,
                     "t_delta": round(t_delta, 4), "t_gc": round(gc_pause, 4),
                     "gc_max_pause": round(gc_max, 4), "n_gc2": gc_counts[2]},
                    commit=False,
                )
                t = lap("t_surrogate", t)

            _, imag_rmean = self.imagine(horizon)
            t = lap("t_imagine", t)

            pol_metrics = self.update_policy()
            t = lap("t_policy", t)

            packed = self._pack_scalars(collect_rmean, imag_rmean, pol_metrics)
            pulled = dict(zip(LOG_SCALARS, packed.tolist()))
            t = lap("t_pull", t)
            self._warm = True

        if eval_iter:
            self.logger.log(self.evaluate_policy(), commit=False)
            self.logger.log(self.evaluate_surrogate(), commit=False)
            wmean, wstd = torch.stack(R.episode_returns(self.world_replay)).tolist()
            self.logger.log({"world_return_mean": wmean, "world_return_std": wstd},
                            commit=False)
            timings["t_eval"] = round(time.perf_counter() - t, 4)  # ends in pulls

        self._commit_record({
            "iteration": self.iteration,
            "num_steps_sampled": self.num_steps_sampled + cfg.learning_starts,
            "horizon": horizon,
            "num_pol_updates": self.num_pol_updates,
            **timings,
            **self._take_captures(),
            "time": time.time() - self._start_time,
        }, pulled)
        self.iteration += 1

    def graph_summary(self) -> Dict[str, Dict]:
        """The CUDA graphs this controller captured, by route (``fused``,
        ``phases``, ``fit``): their keys, their capture seconds and what
        they added to the shared pool."""
        cache = self.graphs or self.trainer.graphs
        out: Dict[str, Dict] = {}
        for key, graph in ({} if cache is None else cache.graphs).items():
            route = ("fused" if isinstance(key[0], int)
                     else "fit" if key[0].startswith("fit") else "phases")
            r = out.setdefault(route, {"keys": [], "t_capture": 0.0, "graph_pool_mb": 0.0})
            r["keys"].append(list(key))
            r["t_capture"] = round(r["t_capture"] + graph.seconds, 4)
            r["graph_pool_mb"] = round(r["graph_pool_mb"] + graph.pool_bytes / 1e6, 3)
        return out

    def _take_captures(self) -> Dict[str, float]:
        log, self._capture_log = self._capture_log, {}
        return log
