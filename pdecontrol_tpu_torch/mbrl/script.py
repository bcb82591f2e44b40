"""MBPO CLI entry point of the port (port of ``pdecontrol_tpu/mbrl/script.py``;
reference ``pdecontrol/mbrl/script.py``).

The same flag names as the JAX CLI: JSON-dict-valued flags for
model/surrogate/training/curriculum/trainer are deep-merged over the factory
defaults; components are chosen by registry name.  Run e.g.:

    python -m pdecontrol_tpu_torch.mbrl.script --solver pallas \
        --training '{"tau": 5, "initial": {"tbtt": 10, "patience": 10,
                     "batch_size": 64}, "iterations": {"tbtt": 10,
                     "patience": 5, "batch_size": 64}}' \
        --trainer '{"initial": {"min_steps": 250, "max_steps": 2000},
                    "iterations": {"min_steps": 50, "max_steps": 250}}' \
        --curriculum '{"scheduler": "LinearScheduler", "steptype":
                       "iteration", "start": 0, "stop": 10, "vmin": 15,
                       "vmax": 15}' \
        --learning_starts 5000 --policy_train_steps_per_sample 10 \
        --rollout_length_schedule '{"scheduler": "LinearScheduler",
            "steptype": "iteration", "start": 0, "stop": 200, "vmin": 3,
            "vmax": 7}'

It runs on the GPU, and stops if there is none, unless ``--platform cpu``
asks for the CPU.
By default an iteration that does not retrain runs as one body, on the GPU
a CUDA graph captured at the first such iteration of each horizon and
replayed from then on, and its metrics record is committed one iteration
late (``t_dispatch``, ``t_ready``; ``t_fused`` on an evaluation iteration),
with each phase's device time between the stamps its graph writes
(``t_dev_collect``, ``t_dev_imagine``, ``t_dev_policy``) and the card's wait
since the previous replay (``t_dev_wait``);
a retrain iteration runs its phases one after another, on the GPU each a
replayed CUDA graph, and so does every iteration under
``--no_fuse_iteration``, each phase then timed after a device
synchronisation (``t_collect``, ``t_imagine``, ``t_policy``, ``t_pull``).
A retrain fits all ensemble members in lock-step, on the GPU each TBPTT
step and each validation step a replayed CUDA graph, with one pull of the
members' val losses per epoch (``t_fit_prep``, ``t_fit_dispatch``,
``t_fit_ready``; the device's ``t_fit_dev_step``, ``t_fit_dev_val``,
``t_fit_dev_wait``; the member-steps computed and those of stopped
members, ``fit_member_steps`` and ``fit_masked_member_steps``); ``--no_fuse_fit`` runs the fit eagerly (``t_fit_val`` in
place of ``t_fit_ready``), and ``--sequential_member_training`` fits one
member after another (each step a replayed graph unless ``--no_fuse_fit``),
its record carrying the last member's fit logs.  ``--checkpoint_freq N`` snapshots the whole
training state every N iterations into ``<run_dir>/checkpoints`` and
``--resume`` carries on from the last snapshot, appending to the same
``metrics.jsonl``; ``--profile_dir`` writes a ``torch.profiler`` trace of
iteration 1 and beside it ``spans-<time>.jsonl``, the loop's host spans and
that iteration's device stamps on the host's clock; ``--debug_nans`` turns on autograd's anomaly detection and
finiteness checks at the phase boundaries (each waits for the device), and
so runs the eager phases.  ``--factory`` takes each of the five families,
``--env_id`` the KS and the Burgers env (which
takes no ``--solver``), ``--loss`` ``MSELoss``, ``KSPhyPDELoss``,
``BurgersPhyPDELoss`` or ``PhyPDELoss``.  ``--wandb``, which is not ported,
raises.

A device mesh (``--data_parallel D --model_parallel M``) runs as D x M
processes, one per rank, each started with the same arguments and
``--coordinator_address host:port --num_processes D*M --process_id i``
(rank 0 listens at the address; ``file:///path`` names a rendezvous file
instead).  Rank ``i`` runs on card ``i`` modulo the cards present, or on
the CPU under ``--platform cpu``; the ranks meet through NCCL when each has
a card of its own and through gloo otherwise.  Under NCCL every route
replays CUDA graphs as on one card; under gloo the fits do, and the rest
runs eagerly (``controller.graph_routes``).  Only rank 0 writes files.
Each rank, and a run without a mesh, prints one ``[rank]`` line at the end
with its routes, the graphs it captured, its replays' ring positions, its
kernels' launches and rows and its peak device memory; on the GPU every
evaluation iteration prints a ``[memory]`` line with the peak allocated so
far.
``runscripts/mbpo_ks_mesh.sh``'s arguments at ``DATA_PARALLEL=2
MODEL_PARALLEL=2`` (on one card through gloo, on four through NCCL; see
``parallel/mesh_smoke.py``):

    for i in 0 1 2 3; do
      python -m pdecontrol_tpu_torch.mbrl.script --solver pallas \
          --data_parallel 2 --model_parallel 2 --num_envs 20 \
          --num_dynamics_models 6 --num_elite_models 6 \
          --model_rollouts_batch_size 200 --policy_batch_size 512 ... \
          --coordinator_address localhost:29500 --num_processes 4 --process_id $i &
    done; wait
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

from pdecontrol_tpu_torch.mbrl.config import MBPOConfig
from pdecontrol_tpu_torch.models.factories import REGISTRY
from pdecontrol_tpu_torch.utils.device import add_platform_argument, platform_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_platform_argument(p)
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first non-finite value seen at "
                        "a phase boundary; anomaly detection in the backward passes")
    # Logging & evaluation
    p.add_argument("--project", type=str, default=None)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--run_dir", type=str, default="runs/mbpo")
    p.add_argument("--offline", action="store_true",
                   help="disable wandb (local JSONL logging only)")
    p.add_argument("--wandb", action="store_true", help="not yet ported")
    p.add_argument("--agent_eval_freq", type=int, default=50)
    p.add_argument("--num_eval_episodes", type=int, default=10)
    p.add_argument("--surrogate_eval_horizon", type=int, default=30)
    p.add_argument("--status_report_freq", type=int, default=5)
    p.add_argument("--logging_freq", type=int, default=10)
    p.add_argument("--checkpoint_freq", type=int, default=0,
                   help="iterations between snapshots of the training state (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="carry on from the last snapshot in <run_dir>/checkpoints")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of iteration 1 here, and the loop's "
                        "host spans and device stamps beside it")
    p.add_argument("--no_fuse_iteration", action="store_true",
                   help="run every iteration's phases one after another (on the GPU each "
                        "its own CUDA graph), each timed after a device synchronisation, in "
                        "place of one CUDA graph per non-retrain iteration")
    p.add_argument("--no_fuse_fit", action="store_true",
                   help="run the surrogate fit eagerly (lock-step or one member after "
                        "another), in place of its TBPTT and validation steps as CUDA graphs")
    # General
    p.add_argument("--total_timesteps", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    # Device mesh
    p.add_argument("--data_parallel", type=int, default=1,
                   help="mesh size sharding env/training batches")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="mesh size sharding ensemble members")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0 (or a file:// rendezvous) of a mesh's "
                        "processes")
    p.add_argument("--num_processes", type=int, default=1,
                   help="processes of the mesh: data_parallel x model_parallel")
    p.add_argument("--process_id", type=int, default=0, help="this process's rank")
    # Env & rollouts
    p.add_argument("--env_id", default="KuramotoSivashinskyEnv-v0")
    p.add_argument("--env_config", type=str, default="{}")
    p.add_argument("--solver", type=str, default=None,
                   choices=["xla", "pallas", "pallas_packed"],
                   help="control-period backend (shorthand for env_config['solver']): "
                        "'xla' the plain PyTorch path, 'pallas' the float32 CUDA kernel, "
                        "'pallas_packed' the bf16-limb CUDA kernel at "
                        "env_config['pallas_precision']")
    p.add_argument("--num_envs", "--cpus", dest="num_envs", type=int, default=10)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--capacity", type=int, default=1_000_000)
    p.add_argument("--rollout_length", type=int, default=1)
    p.add_argument("--pool_size", type=int, default=256)
    p.add_argument("--agent_stride", type=int, default=1,
                   help="sensor stride on the SAC agent's observations")
    p.add_argument("--world_stride", type=int, default=1,
                   help="sensor stride on the surrogate's world space (>1 rejected)")
    # MBPO
    p.add_argument("--learning_starts", type=int, default=20_000)
    p.add_argument("--policy_train_steps_per_sample", type=int, default=5)
    p.add_argument("--model_buffer_store_iterations", type=int, default=30)
    p.add_argument("--model_rollouts_per_sample", type=int, default=100)
    p.add_argument("--model_rollouts_batch_size", type=int, default=100)
    p.add_argument("--model_buffer_max_capacity", type=int, default=1_000_000)
    p.add_argument("--val_split_ratio", type=float, default=0.1)
    p.add_argument("--rollout_length_schedule", type=str, default="{}")
    # Surrogate training
    p.add_argument("--surrogate_train_freq", type=int, default=500)
    p.add_argument("--loss", type=str, default="MSELoss")
    p.add_argument("--factory", type=str, default="KSAutoRegConvolutionalLSTM")
    p.add_argument("--model", type=str, default="{}")
    p.add_argument("--surrogate", type=str, default="{}")
    p.add_argument("--training", type=str, default="{}")
    p.add_argument("--curriculum", type=str, default="{}")
    p.add_argument("--trainer", type=str, default="{}")
    # Ensemble
    p.add_argument("--num_dynamics_models", type=int, default=3)
    p.add_argument("--num_elite_models", type=int, default=3)
    p.add_argument("--sequential_member_training", action="store_true",
                   help="fit the ensemble members one after another, in place of all "
                        "of them in lock-step")
    # SAC
    p.add_argument("--policy", type=str, default="Gaussian")
    p.add_argument("--policy_batch_size", type=int, default=256)
    p.add_argument("--tau", dest="sac_tau", type=float, default=0.005)
    p.add_argument("--target_entropy", type=float, default=-3.0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--target_update_interval", type=int, default=1)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--automatic_entropy_tuning", action="store_true")
    p.add_argument("--reward_scale", type=float, default=1.0,
                   help="SAC-update reward scaling")
    return p


def config_from_args(args: argparse.Namespace) -> MBPOConfig:
    cfg = MBPOConfig(
        project=args.project,
        name=args.name,
        run_dir=args.run_dir,
        use_wandb=args.wandb and not args.offline,
        agent_eval_freq=args.agent_eval_freq,
        num_eval_episodes=args.num_eval_episodes,
        surrogate_eval_horizon=args.surrogate_eval_horizon,
        status_report_freq=args.status_report_freq,
        logging_freq=args.logging_freq,
        checkpoint_freq=args.checkpoint_freq,
        resume=args.resume,
        profile_dir=args.profile_dir,
        fuse_iteration=not args.no_fuse_iteration,
        fuse_fit=not args.no_fuse_fit,
        total_timesteps=args.total_timesteps,
        seed=args.seed,
        data_parallel=args.data_parallel,
        model_parallel=args.model_parallel,
        env_id=args.env_id,
        env_config=(
            {**json.loads(args.env_config), "solver": args.solver}
            if args.solver else json.loads(args.env_config)
        ),
        num_envs=args.num_envs,
        gamma=args.gamma,
        capacity=args.capacity,
        rollout_length=args.rollout_length,
        pool_size=args.pool_size,
        agent_stride=args.agent_stride,
        world_stride=args.world_stride,
        learning_starts=args.learning_starts,
        policy_train_steps_per_sample=args.policy_train_steps_per_sample,
        model_buffer_store_iterations=args.model_buffer_store_iterations,
        model_rollouts_per_sample=args.model_rollouts_per_sample,
        model_rollouts_batch_size=args.model_rollouts_batch_size,
        model_buffer_max_capacity=args.model_buffer_max_capacity,
        val_split_ratio=args.val_split_ratio,
        rollout_length_schedule=json.loads(args.rollout_length_schedule),
        surrogate_train_freq=args.surrogate_train_freq,
        loss=args.loss,
        factory=args.factory,
        model=json.loads(args.model),
        surrogate=json.loads(args.surrogate),
        training=json.loads(args.training),
        curriculum=json.loads(args.curriculum),
        trainer=json.loads(args.trainer),
        num_dynamics_models=args.num_dynamics_models,
        num_elite_models=args.num_elite_models,
        vmap_ensemble_training=not args.sequential_member_training,
        policy=args.policy,
        policy_batch_size=args.policy_batch_size,
        sac_tau=args.sac_tau,
        target_entropy=args.target_entropy,
        lr=args.lr,
        alpha=args.alpha,
        target_update_interval=args.target_update_interval,
        hidden_size=args.hidden_size,
        automatic_entropy_tuning=args.automatic_entropy_tuning,
        reward_scale=args.reward_scale,
    )
    factory = REGISTRY.get(args.factory)
    return cfg.merged_with_factory_defaults(factory.defaults if factory else {})


def rank_report(ctl) -> str:
    """One rank's line (a process without a mesh is rank 0 with no
    backend): its place, device and backend, the routes that may
    replay graphs and the graphs it captured, its last retrain's
    ``t_fit_total``, each replay's ``next_row`` beside its ``num_rows``
    (past it, the ring has wrapped), its kernels' launches and rows, and
    its peak device memory."""
    import torch
    import torch.distributed as dist

    from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed

    dev = ctl.device
    mesh = dist.is_available() and dist.is_initialized()
    return "[rank] " + json.dumps({
        "rank": dist.get_rank() if mesh else 0, "device": str(dev),
        "backend": dist.get_backend() if mesh else None,
        "env_rows": [ctl.env_rows.start, ctl.env_rows.stop],
        "routes": ctl.routes, "graphs": ctl.graph_summary(),
        "t_fit_total": ctl.logger.summary.get("t_fit_total"),
        "replay_rows": [int(ctl.replay.next_row), ctl.replay.num_rows],
        "world_rows": [int(ctl.world_replay.next_row), ctl.world_replay.num_rows],
        "K1": pallas_ks.launch_count, "K1_rows": pallas_ks.rows_launched,
        "K2": pallas_ks_packed.launch_count, "K2_rows": pallas_ks_packed.rows_launched,
        "peak_allocated_mb": (round(torch.cuda.max_memory_allocated(dev) / 1e6, 1)
                              if dev.type == "cuda" else None),
    })


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    device = platform_device(args.platform)
    ranks = config.data_parallel * config.model_parallel
    if args.coordinator_address and args.num_processes != ranks:
        raise ValueError(f"--num_processes {args.num_processes} is not the "
                         f"{config.data_parallel}x{config.model_parallel} mesh's {ranks} ranks")

    import torch

    from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
    from pdecontrol_tpu_torch.parallel import distributed

    if args.coordinator_address:
        # Before the controller, whose mesh is made of the process group.
        device = distributed.initialize(args.coordinator_address, args.num_processes,
                                        args.process_id, args.platform)
    try:
        mbpo = PDEModelBasedController(config, device=device, debug_nans=args.debug_nans)
        anomaly = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(anomaly or args.debug_nans)
        try:
            mbpo.learn()
        except Exception:
            print(traceback.format_exc(), file=sys.stderr)
            return 1
        finally:
            torch.autograd.set_detect_anomaly(anomaly)
            mbpo.logger.finish()
        print(rank_report(mbpo), flush=True)
        return 0
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
