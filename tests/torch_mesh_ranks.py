"""Rank processes of the port's mesh tests (``tests/test_torch_parallel.py``,
and the ``cuda`` cases of ``tests/test_torch_cuda.py``).  It imports torch
and the port only: the JAX side of a comparison is computed by the test and
handed over as files.

    python tests/torch_mesh_ranks.py MODE RANK RANKS ADDRESS DIR [--platform cpu]

MODE is one of:

  * ``sharded``: the three sharded steps of ``parallel/sharded.py`` at
    2x2, in float64, on the inputs (and the surrogate family) in
    ``DIR/inputs.npz`` and
    ``DIR/sac_state.pt``; each rank writes ``DIR/sharded{RANK}.npz``;
  * ``controller``: on the test's tiny config at 2x2, ``collect(6,
    random=True)`` of a fresh controller, then a ``learn()`` with a
    snapshot every 2 iterations in a run directory of the rank's own, every
    rank's restore of the primary's last snapshot, and a ``--resume`` of the
    primary's run for 2 more iterations; each rank writes
    ``DIR/controller{RANK}.json`` (and rank 0 ``DIR/collect.npz``);
  * ``cuda``: two ranks on one card through gloo: a gather against local
    concatenation, the sharded collect through K1 against one rank's, a
    SAC update whose averaged gradients leave the networks on the card, and
    200 float32 updates of the flagship's agent at batch 512 with ``SAC(mesh=)``
    against the same batches and noises in one process (``sac_series``); each
    rank writes ``DIR/cuda{RANK}.json``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch

F64 = torch.float64


def controller_config(run_dir, data_parallel=1, model_parallel=1, **changes):
    """``tests/test_parallel.py``'s tiny full-iteration config (its
    ``test_full_iteration_mesh_equivalence``), with the reset transient cut
    to 0.5 time units and a snapshot every 2 iterations."""
    from pdecontrol_tpu_torch.mbrl.config import MBPOConfig

    cfg = dict(
        run_dir=run_dir,
        env_config={"n": 16, "cfg_steps": 5, "t_max": 0.04, "transient_time": 0.5},
        data_parallel=data_parallel, model_parallel=model_parallel,
        num_envs=4, total_timesteps=28, learning_starts=16,
        capacity=512, pool_size=8, surrogate_train_freq=8,
        policy_train_steps_per_sample=1, model_rollouts_per_sample=2,
        model_rollouts_batch_size=4, model_buffer_store_iterations=2,
        model_buffer_max_capacity=64, num_dynamics_models=2,
        num_elite_models=2, policy_batch_size=8, agent_eval_freq=1,
        num_eval_episodes=2, surrogate_eval_horizon=4,
        logging_freq=0, status_report_freq=100, checkpoint_freq=2,
        rollout_length_schedule={"scheduler": "ConstantLengthScheduler", "length": 2},
        training={"tau": 2, "tbtt": 4, "patience": 1, "batch_size": 4,
                  "min_steps": 1, "max_steps": 3},
        curriculum={"scheduler": "ConstantLengthScheduler", "length": 3},
    )
    cfg.update(changes)
    return MBPOConfig(**cfg)


# The total steps of the resumed run: 2 iterations more.
RESUME_TIMESTEPS = 32


def run_sharded(rank, outdir, device):
    from pdecontrol_tpu_torch.data.types import Sample
    from pdecontrol_tpu_torch.envs.kuramoto import EnvState, KuramotoSivashinsky
    from pdecontrol_tpu_torch.envs.transforms import Identity
    from pdecontrol_tpu_torch.models import factories
    from pdecontrol_tpu_torch.models.surrogate import stack_parameters
    from pdecontrol_tpu_torch.parallel.mesh import make_mesh
    from pdecontrol_tpu_torch.parallel.sharded import (sharded_collect_fn,
                                                        sharded_ensemble_train_fn,
                                                        sharded_sac_update_fn)
    from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig
    from pdecontrol_tpu_torch.train.losses import make_loss
    from pdecontrol_tpu_torch.train.trainer import SurrogateTrainer, TrainConfig, TrainerState

    mesh = make_mesh(2, 2)
    npz = dict(np.load(os.path.join(outdir, "inputs.npz")))
    family = str(npz.pop("family"))
    z = {k: torch.as_tensor(v) for k, v in npz.items()}
    out = {}

    env = KuramotoSivashinsky.create(n=16, cfg_steps=4, dtype=F64, solver="xla")
    state = EnvState(u=z["collect_u"], step=torch.zeros(4, dtype=torch.int32),
                     generator=torch.Generator().manual_seed(0))
    collect, place = sharded_collect_fn(mesh, env, nsteps=3)
    state, rewards = collect(*place(state, z["collect_actions"], z["pool"]))
    out.update(collect_rewards=rewards, collect_u=state.u)

    m = z["train_states"].shape[0]
    modules = [factories.make(family, delta=0.25, N=16).double()
               for _ in range(m)]
    params = stack_parameters(modules)
    params.copy_(z["train_params"])
    tstate = TrainerState(modules, params, z["train_exp_avg"].clone(),
                          z["train_exp_avg_sq"].clone(), z["train_count"].clone(),
                          z["train_global_step"].clone())
    trainer = SurrogateTrainer(make_loss("MSELoss", {}), TrainConfig(tau=2, tbtt=3, batch_size=4))
    train, place = sharded_ensemble_train_fn(mesh, trainer)
    tstate, metrics = train(*place(tstate, z["train_states"], z["train_actions"]), Identity(),
                            torch.tensor(1e-3, dtype=F64))
    out.update(train_loss=metrics["train_loss"],
               **{f"train_{k}": t for k, t in zip(
                   ("params", "exp_avg", "exp_avg_sq", "count", "global_step"), tstate.tensors())})

    sac = SAC((1, 16), (1, 4), SACConfig(hidden=32))
    sac_state = sac.init(dtype=F64)
    saved = torch.load(os.path.join(outdir, "sac_state.pt"), weights_only=True)
    for name in ("policy", "critic", "target"):
        getattr(sac_state, name).load_state_dict(saved[name])
    batch = Sample(obs=z["sac_obs"], actions=z["sac_actions"], nxtobs=z["sac_nxtobs"],
                   rewards=z["sac_rewards"], terminated=z["sac_terminated"],
                   truncated=z["sac_truncated"], steps=z["sac_steps"])
    update, place = sharded_sac_update_fn(mesh, sac)
    sac_state, sm = update(*place(sac_state, batch), noise=(z["sac_noise_next"],
                                                           z["sac_noise_pi"]))
    out.update({f"sac_{k}": sm[k] for k in ("qf_loss", "policy_loss")})
    for name in ("policy", "critic", "target"):
        for k, v in getattr(sac_state, name).state_dict().items():
            out[f"sac_{name}.{k}"] = v
    np.savez(os.path.join(outdir, f"sharded{rank}.npz"),
             **{k: v.detach().numpy() for k, v in out.items()})


def run_controller(rank, outdir, device):
    from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
    from pdecontrol_tpu_torch.parallel.dryrun_mp import files_under, restore_matches

    def make(run_dir, **changes):
        return PDEModelBasedController(controller_config(run_dir, 2, 2, **changes),
                                       device=device)

    ctl = make(os.path.join(outdir, f"collect_p{rank}"), checkpoint_freq=0)
    rewards, _ = ctl.collect(6, random=True)
    if rank == 0:
        np.savez(os.path.join(outdir, "collect.npz"), rewards=rewards.numpy(),
                 obs_seq=ctl.replay.obs_seq.numpy())
    ctl.logger.finish()

    run_dir = os.path.join(outdir, f"run_p{rank}")
    primary_dir = os.path.join(outdir, "run_p0")
    first = make(run_dir)
    first.learn()
    first.logger.finish()
    files = files_under(run_dir)
    restore_ok = restore_matches(first, os.path.join(primary_dir, "checkpoints"))
    resumed = make(primary_dir, total_timesteps=RESUME_TIMESTEPS, resume=True)
    restored = resumed.restored
    resumed.learn()
    resumed.logger.finish()
    with open(os.path.join(outdir, f"controller{rank}.json"), "w") as f:
        json.dump({"primary": first.primary, "files": files, "restore_ok": restore_ok,
                   "restored": restored, "iteration": resumed.iteration,
                   "params": float(resumed.ensemble.params.double().sum()),
                   "generator": resumed.gen.get_state().tolist()[:64]}, f)


def run_cuda(rank, outdir, device):
    from pdecontrol_tpu_torch.data.types import Sample
    from pdecontrol_tpu_torch.envs.kuramoto import KuramotoSivashinsky
    from pdecontrol_tpu_torch.parallel.mesh import make_mesh
    from pdecontrol_tpu_torch.parallel.sharded import sharded_collect_fn, sharded_sac_update_fn
    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig

    mesh = make_mesh(2, 1)
    out = {"device": str(device), "backend": torch.distributed.get_backend()}

    # A gather: every rank's rows of three tensors of three dtypes.
    gen = torch.Generator(device=device).manual_seed(5)
    whole = [torch.randn((8, 3, 64), generator=gen, device=device),
             torch.randint(0, 1000, (8,), generator=gen, device=device, dtype=torch.int32),
             torch.rand((8,), generator=gen, device=device) < 0.5]
    rows = mesh.data_slice(8)
    got = mesh.gather([t[rows] for t in whole])
    out["gather_equal"] = all(torch.equal(g, w) and g.dtype == w.dtype and g.is_cuda
                              for g, w in zip(got, whole))

    # The sharded collect through K1 against the same steps on one rank.
    env = KuramotoSivashinsky.create(solver="pallas", device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    pool = torch.rand((16, env.n), generator=gen, device=device) * 0.8 - 0.4
    state = env.reset_from_pool(gen, pool, (10,))
    actions = torch.rand((3, 10, 1, 4), generator=gen, device=device) * 2 - 1
    start = gen.get_state()
    before = pallas_ks.launch_count, pallas_ks.rows_launched
    collect, place = sharded_collect_fn(mesh, env, nsteps=3)
    sharded, rewards = collect(*place(state, actions, pool))
    out["k1"] = [pallas_ks.launch_count - before[0], pallas_ks.rows_launched - before[1]]
    gen.set_state(start)
    ref, ref_rewards = state, []
    for a in actions:
        ref, o = env.vec_step(ref, a, pool)
        ref_rewards.append(o.reward)
    out["collect_equal"] = (torch.equal(rewards, torch.stack(ref_rewards))
                            and torch.equal(sharded.u, ref.u)
                            and torch.equal(sharded.step, ref.step))

    # One SAC update with the batch over data.
    torch.manual_seed(0)
    sac = SAC((1, env.n), (1, 4), SACConfig(), device=device)
    sac_state = sac.init()
    n = 32
    batch = Sample(obs=torch.randn((n, 1, env.n), generator=gen, device=device),
                   actions=torch.rand((n, 1, 4), generator=gen, device=device) * 2 - 1,
                   nxtobs=torch.randn((n, 1, env.n), generator=gen, device=device),
                   rewards=torch.randn((n,), generator=gen, device=device),
                   terminated=torch.zeros((n,), dtype=torch.bool, device=device),
                   truncated=torch.zeros((n,), dtype=torch.bool, device=device),
                   steps=torch.zeros((n,), dtype=torch.int32, device=device))
    ref_state = copy.deepcopy(sac_state)
    start = gen.get_state()
    ref_state, ref_m = sac.update(ref_state, batch, gen)
    gen.set_state(start)
    update, place = sharded_sac_update_fn(mesh, sac)
    sac_state, m = update(*place(sac_state, batch), gen)
    nets = [p for name in ("policy", "critic") for p in getattr(sac_state, name).parameters()]
    ref_nets = [p for name in ("policy", "critic")
                for p in getattr(ref_state, name).parameters()]
    out["sac_on_card"] = all(p.is_cuda and p.grad.is_cuda for p in nets)
    out["sac_gap"] = max(float((a - b).abs().max()) for a, b in zip(nets, ref_nets))
    out["sac_qf_gap"] = float((m["qf_loss"] - ref_m["qf_loss"]).abs())
    out["sac_params"] = float(sum(p.double().sum() for p in nets))
    out.update(sac_series(mesh, device))
    with open(os.path.join(outdir, f"cuda{rank}.json"), "w") as f:
        json.dump(out, f)


def sac_series(mesh, device, updates=200, batch=512):
    """The last of ``updates`` SAC updates of the flagship's agent (64-point
    obs, 4 jets, hidden 256) at ``batch``, in float32 and in float64: with
    ``SAC(mesh=)`` on this rank's half of each batch and noise, in one
    process on the whole batch, and in one process on the batch's rows in
    reverse order (another summation order alone).  Returns each float32
    run's last losses and, per dtype, the relative gaps of the mesh and of
    the reversed rows to the one-process run."""
    from pdecontrol_tpu_torch.data.types import Sample
    from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig

    gen = torch.Generator(device=device).manual_seed(1)

    def draw(*shape):
        return torch.rand(shape, generator=gen, device=device)

    batches = [(Sample(obs=draw(batch, 1, 64) * 2 - 1, actions=draw(batch, 1, 4) * 2 - 1,
                       nxtobs=draw(batch, 1, 64) * 2 - 1, rewards=-draw(batch),
                       terminated=torch.zeros(batch, dtype=torch.bool, device=device),
                       truncated=torch.zeros(batch, dtype=torch.bool, device=device),
                       steps=torch.zeros(batch, dtype=torch.int32, device=device)),
                (torch.randn((batch, 1, 4), generator=gen, device=device),
                 torch.randn((batch, 1, 4), generator=gen, device=device)))
               for _ in range(updates)]
    rows = mesh.data_slice(batch)
    whole = torch.arange(batch, device=device)
    out = {}
    for dtype, tag in ((torch.float32, ""), (torch.float64, "float64_")):
        def cast(x):
            return x.to(dtype) if x.is_floating_point() else x

        last = {}
        for name, agent_mesh, take in (("mesh", mesh, rows), ("one", None, whole),
                                       ("reversed", None, whole.flip(0))):
            torch.manual_seed(0)
            sac = SAC((1, 64), (1, 4), SACConfig(), device=device, mesh=agent_mesh)
            state = sac.init(dtype)
            for sample, noise in batches:
                state, m = sac.update(state, sample.apply(lambda x: cast(x[take])),
                                      noise=tuple(cast(x[take]) for x in noise))
            m = sac.global_metrics(m)
            last[name] = {k: float(m[k]) for k in ("qf_loss", "policy_loss")}
        for a in ("mesh", "reversed"):
            out[f"sac_series_{tag}{'reorder' if a == 'reversed' else a}_gaps"] = {
                k: abs(last[a][k] - last["one"][k]) / abs(last["one"][k]) for k in last["one"]}
        if not tag:
            out["sac_series_last"] = last
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("sharded", "controller", "cuda"))
    p.add_argument("rank", type=int)
    p.add_argument("ranks", type=int)
    p.add_argument("address")
    p.add_argument("outdir")
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    from pdecontrol_tpu_torch.parallel import distributed

    device = distributed.initialize(args.address, args.ranks, args.rank, args.platform)
    try:
        {"sharded": run_sharded, "controller": run_controller, "cuda": run_cuda}[args.mode](
            args.rank, args.outdir, device)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
