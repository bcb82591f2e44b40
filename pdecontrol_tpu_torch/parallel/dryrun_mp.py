"""One rank of the multi-process dry run (port of
``pdecontrol_tpu/parallel/dryrun_mp.py``); ``parallel/dryrun.py`` starts
the ranks and holds their receipts to each other.

    python -m pdecontrol_tpu_torch.parallel.dryrun_mp RANK N ADDRESS OUTDIR [--platform cpu]
    python -m pdecontrol_tpu_torch.parallel.dryrun_mp single N OUTDIR [--platform cpu]

A rank joins the process group at ``ADDRESS`` and runs, on the JAX
package's tiny shapes (the env's grid at ``N_GRID``), over the ``data x
model`` mesh of ``N`` ranks:

  1. the sharded env collect (3 steps through K1 on the card);
  2. one lock-step gradient step of the ensemble, the members over
     ``model`` (float64);
  3. one SAC update, the batch over ``data`` (float64);
  4. a full ``learn()`` on the mesh with a snapshot after every iteration,
     each rank in a run directory of its own, then a restore of the
     primary's last snapshot on every rank.

Each of stages 1-3 is also run without the mesh on the rank's own device
from the same generator state, and the largest gap is recorded.  ``single``
runs stage 4's ``learn()`` in one process without a mesh (the JAX package's
single-process reference), with the phases one after another.  Every process
writes its receipts as JSON into ``OUTDIR``: digests of what must be equal
on every rank (the replicated results, the generator's state after each
stage and after each phase of ``learn()``), the files each run directory
holds and the restore's outcome.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
from typing import Dict, List

import torch

# The grid: JAX's dry run takes 16 points; K1 takes a multiple of 32 (each
# lane of a row's warp holds n / 32 points), so the stages that step the env
# take 32, the smallest it runs.
N_GRID = 32
# Stages 2 and 3 run in float64, so that their gaps to the step without the
# mesh (another summation order) stay near float64 rounding.
F64 = torch.float64
# learn()'s phases after which a rank notes its generator's state.
PHASES = ("collect", "update_delta_transform", "update_surrogates", "imagine",
          "update_policy", "evaluate_policy", "evaluate_surrogate")


def digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def gen_digest(gen: torch.Generator) -> str:
    return digest(gen.get_state())


def mesh_shape(n: int):
    """The JAX dry run's mesh of ``n`` devices: model 2 where ``n`` is even."""
    model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    return n // model_parallel, model_parallel


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def learn_config(run_dir: str, data_parallel: int, model_parallel: int, ranks: int,
                 **changes):
    """The JAX dry run's tiny full-loop config (``dryrun_mp._learn_config``)
    with its batches sized for a mesh of ``ranks`` devices as ``data x
    model``, on a mesh of ``data_parallel x model_parallel``: every batch
    splits over the mesh, and a 1x1 run of the same sizes is its
    single-process reference.  The reset transient is cut to 0.5 time
    units, and the env steps through K1 on ``N_GRID`` points."""
    from pdecontrol_tpu_torch.mbrl.config import MBPOConfig

    ds, mp = mesh_shape(ranks)
    return MBPOConfig(
        run_dir=run_dir,
        env_config={"n": N_GRID, "cfg_steps": 5, "t_max": 0.04, "transient_time": 0.5,
                    "solver": "pallas"},
        data_parallel=data_parallel,
        model_parallel=model_parallel,
        num_envs=2 * ds,
        total_timesteps=8 * ds + 4 * ds,
        learning_starts=8 * ds,
        capacity=512,
        pool_size=8,
        surrogate_train_freq=4 * ds,
        policy_train_steps_per_sample=1,
        model_rollouts_per_sample=2,
        model_rollouts_batch_size=2 * ds,
        model_buffer_store_iterations=2,
        model_buffer_max_capacity=64,
        num_dynamics_models=2 * mp,
        num_elite_models=2 * mp,
        policy_batch_size=4 * ds,
        agent_eval_freq=1,
        num_eval_episodes=2,
        surrogate_eval_horizon=3,
        logging_freq=1,
        status_report_freq=100,
        checkpoint_freq=1,
        rollout_length_schedule={"scheduler": "ConstantLengthScheduler", "length": 2},
        training={"tau": 2, "tbtt": 4, "patience": 1, "batch_size": 4,
                  "min_steps": 1, "max_steps": 2},
        curriculum={"scheduler": "ConstantLengthScheduler", "length": 3},
        **changes,
    )


def files_under(run_dir: str) -> List[str]:
    out = []
    if os.path.isdir(run_dir):
        for root, _, names in os.walk(run_dir):
            out += [os.path.relpath(os.path.join(root, f), run_dir) for f in names]
    return sorted(out)


def traced_learn(ctl) -> List[List[str]]:
    """``ctl.learn()``, noting the generator's state after each phase."""
    trail = []
    for name in PHASES:
        fn = getattr(ctl, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            trail.append([_name, gen_digest(ctl.gen)])
            return out

        setattr(ctl, name, wrapped)
    ctl.learn()
    return trail


def restore_matches(ctl, directory: str) -> bool:
    """Whether the last snapshot in ``directory``, as this rank keeps it
    (its envs), equals the controller's live state: the counters, the
    generator, the envs, the replay and the members."""
    from pdecontrol_tpu_torch.utils import checkpoint as C

    snap = C.CheckpointManager(directory).restore(map_location="cpu")
    live = C.to_host(C.controller_state(ctl))
    return bool(
        int(snap["counters"]["iteration"]) == ctl.iteration
        and torch.equal(snap["generator"], live["generator"])
        and all(torch.equal(snap["env_state"][k][ctl.env_rows], live["env_state"][k])
                for k in ("u", "step"))
        and torch.equal(snap["replay"]["obs_seq"], live["replay"]["obs_seq"])
        and all(torch.equal(a, b) for sd, live_sd in zip(snap["ensemble"]["members"],
                                                         live["ensemble"]["members"])
                for a, b in zip(sd.values(), live_sd.values())))


def controller_digests(ctl) -> Dict[str, str]:
    """Digests of what a mesh keeps equal on every rank."""
    sac = ctl.sac_state
    return {
        "ensemble": digest(ctl.ensemble.params, ctl.ensemble.elite_mask),
        "fit_state": digest(*ctl.fit_state.tensors()),
        "sac": digest(*sac.policy.parameters(), *sac.critic.parameters(),
                      *sac.target.parameters()),
        "replay": digest(ctl.replay.obs_seq, ctl.replay.rewards, ctl.replay.actions),
        "world_replay": digest(ctl.world_replay.obs_seq, ctl.world_replay.rewards),
        "scaling": digest(ctl.tr.oscaling.vmin, ctl.tr.oscaling.vmax),
        "generator": gen_digest(ctl.gen),
    }


# ----------------------------------------------------------------- stages
def stage_collect(mesh, device) -> Dict:
    from pdecontrol_tpu_torch.envs.kuramoto import KuramotoSivashinsky
    from pdecontrol_tpu_torch.parallel.sharded import sharded_collect_fn

    env = KuramotoSivashinsky.create(n=N_GRID, cfg_steps=4, solver="pallas", device=device)
    batch = 2 * mesh.data_parallel
    gen = torch.Generator(device=device).manual_seed(0)
    pool = torch.rand((8, env.n), generator=gen, device=device) * 0.8 - 0.4
    state = env.reset_from_pool(gen, pool, (batch,))
    actions = torch.rand((3, batch, 1, 4), generator=gen, device=device) * 2 - 1
    start = gen.get_state()

    collect, place = sharded_collect_fn(mesh, env, nsteps=3)
    out, rewards = collect(*place(state, actions, pool))

    gen.set_state(start)  # the same steps without the mesh
    ref = state
    ref_rewards = []
    for a in actions:
        ref, o = env.vec_step(ref, a, pool)
        ref_rewards.append(o.reward)
    ref_rewards = torch.stack(ref_rewards)
    return {"rewards": digest(rewards, out.u, out.step), "generator": gen_digest(gen),
            "gap": max(_gap(rewards, ref_rewards), _gap(out.u, ref.u)),
            "shape": list(rewards.shape)}


def stage_train(mesh, device) -> Dict:
    from pdecontrol_tpu_torch.envs.transforms import Identity
    from pdecontrol_tpu_torch.models import factories
    from pdecontrol_tpu_torch.models.surrogate import init_ensemble
    from pdecontrol_tpu_torch.parallel.sharded import sharded_ensemble_train_fn
    from pdecontrol_tpu_torch.train.losses import make_loss
    from pdecontrol_tpu_torch.train.trainer import SurrogateTrainer, TrainConfig, TrainerState

    n, batch, members = 16, 2 * mesh.data_parallel, 2 * mesh.model_parallel
    torch.manual_seed(0)
    ens = init_ensemble(lambda: factories.make("KSAutoRegConvolutionalLSTM", delta=0.25,
                                               N=n).double(), members, device=device)
    trainer = SurrogateTrainer(make_loss("MSELoss", {}),
                               TrainConfig(tau=2, tbtt=3, batch_size=batch))
    state = trainer.init_members(ens.members, ens.params)
    gen = torch.Generator(device=device).manual_seed(1)
    bs = torch.randn((members, batch, 5, 1, n), generator=gen, dtype=F64, device=device)
    ba = torch.rand((members, batch, 5, 1, n), generator=gen, dtype=F64, device=device)
    lr = torch.tensor(1e-3, dtype=F64, device=device)

    ref = TrainerState(state.modules, *(t.clone() for t in state.tensors()))
    active = torch.ones((members,), dtype=torch.bool, device=device)
    ref_losses = trainer.lockstep_train_step(ref, bs, ba, Identity(), lr, active)

    train, place = sharded_ensemble_train_fn(mesh, trainer)
    state, metrics = train(*place(state, bs, ba), Identity(), lr)
    losses = metrics["train_loss"]
    return {"train_loss": digest(losses), "state": digest(*state.tensors()),
            "gap": max(_gap(losses, ref_losses), _gap(state.params, ref.params)),
            "shape": list(losses.shape)}


def stage_sac(mesh, device) -> Dict:
    from pdecontrol_tpu_torch.data.types import Sample
    from pdecontrol_tpu_torch.parallel.sharded import sharded_sac_update_fn
    from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig

    n, rows = 16, 8 * mesh.data_parallel
    torch.manual_seed(0)
    sac = SAC((1, n), (1, 4), SACConfig(), device=device)
    state = sac.init(dtype=F64)
    gen = torch.Generator(device=device).manual_seed(2)
    batch = Sample(
        obs=torch.randn((rows, 1, n), generator=gen, dtype=F64, device=device),
        actions=torch.rand((rows, 1, 4), generator=gen, dtype=F64, device=device) * 2 - 1,
        nxtobs=torch.randn((rows, 1, n), generator=gen, dtype=F64, device=device),
        rewards=torch.randn((rows,), generator=gen, dtype=F64, device=device),
        terminated=torch.zeros((rows,), dtype=torch.bool, device=device),
        truncated=torch.zeros((rows,), dtype=torch.bool, device=device),
        steps=torch.zeros((rows,), dtype=torch.int32, device=device),
    )
    start = gen.get_state()
    ref_state = copy.deepcopy(state)
    ref_state, ref_m = sac.update(ref_state, batch, gen)

    gen.set_state(start)
    update, place = sharded_sac_update_fn(mesh, sac)
    state, m = update(*place(state, batch), gen)
    params = list(state.policy.parameters()) + list(state.critic.parameters())
    ref_params = list(ref_state.policy.parameters()) + list(ref_state.critic.parameters())
    return {"qf_loss": digest(m["qf_loss"], m["policy_loss"]), "state": digest(*params),
            "generator": gen_digest(gen),
            "gap": max([_gap(m[k], ref_m[k]) for k in ("qf_loss", "policy_loss")]
                       + [_gap(a, b) for a, b in zip(params, ref_params)]),
            "critic_allreduce": time_critic_allreduce(mesh, device)}


def time_critic_allreduce(mesh, device, reps: int = 20) -> Dict:
    """Milliseconds of the collective of one critic step of the flagship
    (its float32 gradients, 64-point obs and 4 jets, hidden 256, averaged
    over ``data``): host clock around ``reps`` calls after 3 warm-ups, each
    ending in a device synchronisation."""
    import time

    from pdecontrol_tpu_torch.parallel.mesh import DATA_AXIS
    from pdecontrol_tpu_torch.sac.nets import QNetwork

    grads = [torch.randn_like(p) for p in QNetwork(64 + 4, hidden=256).to(device).parameters()]

    def once():
        mesh.mean_(grads, DATA_AXIS)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(3):
        once()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    return {"ms": 1e3 * (time.perf_counter() - t0) / reps,
            "bytes": 4 * sum(g.numel() for g in grads)}


def stage_learn(rank: int, ranks: int, outdir: str, device) -> Dict:
    from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController

    dp, mp = mesh_shape(ranks)
    run_dir = os.path.join(outdir, f"run_p{rank}")
    # The phases one after another, as in ``single``, so that the trail
    # sees each of them (under NCCL each replays its graph).
    ctl = PDEModelBasedController(learn_config(run_dir, dp, mp, ranks, fuse_iteration=False),
                                  device=device)
    trail = traced_learn(ctl)
    ctl.logger.finish()
    files = files_under(run_dir)

    # Every rank restores the primary's last snapshot (learn() returned
    # after a barrier behind the primary's last write).
    restore_ok = restore_matches(ctl, os.path.join(outdir, "run_p0", "checkpoints"))
    return {"primary": ctl.primary, "iteration": ctl.iteration, "run_dir": run_dir,
            "files": files, "restore_ok": restore_ok, "trail": trail,
            "digests": controller_digests(ctl)}


def child(rank: int, ranks: int, address: str, outdir: str, platform=None) -> None:
    from pdecontrol_tpu_torch.parallel import distributed
    from pdecontrol_tpu_torch.parallel.mesh import make_mesh

    device = distributed.initialize(address, ranks, rank, platform)
    try:
        mesh = make_mesh(*mesh_shape(ranks))
        record = {"rank": rank, "device": str(device),
                  "backend": torch.distributed.get_backend()}
        for name, stage in (("collect", stage_collect), ("train", stage_train),
                            ("sac", stage_sac)):
            record[name] = stage(mesh, device)
            print(f"[dryrun] rank {rank}: stage {name} ok", flush=True)
        record["learn"] = stage_learn(rank, ranks, outdir, device)
        print(f"[dryrun] rank {rank}: learn ok ({record['learn']['iteration']} iterations)",
              flush=True)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        distributed.shutdown()


def single(ranks: int, outdir: str, platform=None) -> None:
    from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController

    device = torch.device("cpu" if platform == "cpu" else "cuda")
    run_dir = os.path.join(outdir, "run_single")
    # The phases one after another, as on the ranks, and the eager fit: the
    # fused iteration's phases are not seen one by one.
    cfg = learn_config(run_dir, 1, 1, ranks, fuse_iteration=False, fuse_fit=False)
    ctl = PDEModelBasedController(cfg, device=device)
    trail = traced_learn(ctl)
    ctl.logger.finish()
    with open(os.path.join(outdir, "single.json"), "w") as f:
        json.dump({"iteration": ctl.iteration, "run_dir": run_dir, "trail": trail,
                   "digests": controller_digests(ctl)}, f)
    print(f"[dryrun] single process: learn ok ({ctl.iteration} iterations)", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("rank", help="this rank, or 'single'")
    p.add_argument("ranks", type=int)
    p.add_argument("rest", nargs="+", help="ADDRESS OUTDIR (a rank) or OUTDIR (single)")
    p.add_argument("--platform", choices=("cpu", "gpu", "cuda"), default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    platform = "cpu" if args.platform == "cpu" else None
    if args.rank == "single":
        single(args.ranks, args.rest[0], platform)
    else:
        child(int(args.rank), args.ranks, args.rest[0], args.rest[1], platform)


if __name__ == "__main__":
    main()
