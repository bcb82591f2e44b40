"""The mesh on four NVIDIA cards: one NCCL rank per card, its routes
replayed from CUDA graphs as on one card, held to each other and to 1x1.

    python -m pdecontrol_tpu_torch.parallel.mesh_smoke [--out DIR] [--timeout S]
    python -m pdecontrol_tpu_torch.parallel.mesh_smoke one

It needs four cards and raises with fewer: nothing falls back to fewer
ranks or to the CPU.  Every rank is a process of its own on card ``i``
(``parallel/distributed.py``), started through ``parallel/dryrun.py``'s
``launch`` with a wall-clock limit.

  a. the dry run of four ranks (``parallel/dryrun.py``), now through NCCL,
     held to one process as on one card;
  b. ``runscripts/mbpo_ks_mesh.sh``'s arguments at 2x2 (20 envs, 6 members,
     rollout batch 200, policy batch 512), cut in depth (``mesh_args``), on
     three routes on the same four ranks: the default one (the fused
     iteration and the phase graphs), ``--no_fuse_iteration`` (the phase
     graphs) and every route eager (a controller built with
     ``graphs=False``, through this module's rank mode); and the same
     arguments at 1x1 in a process of its own;
  c. the same at 4x1 (40 envs, 3 members, rollout batch 400, policy batch
     1024) on the default and the eager route, and at 1x1.

For b and c it requires: every rank on its own card through NCCL; on the
default route every rank captured the fused iteration and the phase
graphs, and on ``--no_fuse_iteration`` the phase graphs; the routes'
streams (the primary's ``metrics.jsonl``) equal in every field that does
not read the clock, bit for bit; the default route within rtol 2e-4 /
atol 1e-7 of 1x1 on ``tests/test_parallel.py``'s keys up to iteration 0's
SAC updates (``hold_one``); K1 launched on every rank as at 1x1, at the
rank's share of the envs per collect launch, replays included; and one
NCCL ``mean_`` replayed from a graph equal to its eager call bit for bit.
It prints, per rank and route, the captures and what they added to the
pool, the peak memory, each iteration's wall time and each non-retrain
iteration's from its dispatch to its pull, and the time of one ``mean_``
of the flagship critic's gradients eagerly and replayed; then the SAC keys
beside ``sac_reorder_gaps``'s floor, and as its last line one JSON object
of all of it.

``one`` runs on one card what NCCL allows there (``nccl_world_of_one``): a
process group of one NCCL rank, whose ``all_reduce`` a graph captures and
replays bit for bit as its eager call; it prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pdecontrol_tpu_torch.parallel import dryrun

# runscripts/mbpo_ks_mesh.sh with --solver pallas; its batches follow the
# mesh (``mesh_args``).  Cut in depth as chip_smoke.py cuts the main path:
# total_timesteps 50000 -> 5000 + 6 iterations of num_envs steps,
# surrogate_train_freq 500 -> 3 iterations' steps (retrains at iterations 0
# and 3), the trainer's max_steps 2000/250 -> 20/10, checkpoint_freq
# 200 -> 2 (snapshots after iterations 1, 3 and 5).
BASE_ARGS = [
    "--env_id", "KuramotoSivashinskyEnv-v0",
    "--factory", "KSAutoRegConvolutionalLSTM",
    "--training", json.dumps({
        "tau": 5,
        "initial": {"tbtt": 10, "patience": 10, "batch_size": 64},
        "iterations": {"tbtt": 10, "patience": 5, "batch_size": 64}}),
    "--trainer", json.dumps({
        "initial": {"min_steps": 250, "max_steps": 20},
        "iterations": {"min_steps": 50, "max_steps": 10}}),
    "--curriculum", json.dumps({
        "scheduler": "LinearScheduler", "steptype": "iteration",
        "start": 0, "stop": 10, "vmin": 15, "vmax": 15}),
    "--loss", "MSELoss",
    "--learning_starts", "5000",
    "--rollout_length_schedule", json.dumps({
        "scheduler": "LinearScheduler", "steptype": "iteration",
        "start": 0, "stop": 200, "vmin": 3, "vmax": 7}),
    "--policy_train_steps_per_sample", "10",
    "--checkpoint_freq", "2",
    "--solver", "pallas",
]
ITERATIONS = 6
WARMUP = 5000
# The layouts and the routes run on each.
LAYOUTS = {"2x2": (2, 2, ("default", "no_fuse_iteration", "eager")),
           "4x1": (4, 1, ("default", "eager"))}
# K1 launches besides the collects, on every rank and at 1x1: the reset
# pool (920 launches of 64 chains) and two evaluations of 10 episodes of
# 400 steps (800 launches of 10 rows).
OTHER_LAUNCHES = 920 + 800
OTHER_ROWS = 920 * 64 + 800 * 10

# The record keys of tests/test_parallel.py's full-iteration equivalence.
MESH_KEYS = ("collect_reward_mean", "imagined_reward_mean", "train_loss", "val_loss",
             "sac_qf_loss", "sac_policy_loss", "eval_return_mean", "surrogate_open_loop_mse",
             "reward_model_error", "num_ensemble_updates", "horizon")
# Of these, iteration 0's that come after its 200 float32 SAC updates (each
# rank's share of every batch, the gradients averaged over data): the last
# update's losses and the evaluation of the updated policy.  Another
# summation order alone moves them by about 1e-4: one process that only
# reverses the rows of each batch moved the last losses by 1.1e-4 and
# 1.3e-4 on an H100 (``sac_reorder_gaps``), and a mesh's SAC batches also
# differ from 1x1's by ulps (imagined by members fitted as grouped
# convolutions of another size).  So they are printed beside that gap, not
# held (tests/test_parallel.py holds them at 2e-4 in float64, on one SAC
# update per step).
MESH_AFTER_SAC = ("sac_qf_loss", "sac_policy_loss", "eval_return_mean")
# Logged keys that must be finite.  At 20 and 40 envs the 5000-step warmup
# ends before any episode does, so iteration 0's surrogate evaluation finds
# no finished episode and logs no error, in one process as on the mesh.
FINITE = ("train_loss", "val_loss", "sac_qf_loss", "sac_policy_loss", "eval_return_mean",
          "collect_reward_mean", "imagined_reward_mean", "world_return_mean")
PHASE_KINDS = {"collect", "world", "policy", "eval"}


def mesh_args(data_parallel: int, model_parallel: int, run_dir: str) -> List[str]:
    """The cut arguments of ``runscripts/mbpo_ks_mesh.sh`` at
    ``DATA_PARALLEL x MODEL_PARALLEL``: 10 envs, 100 imagined rollouts and a
    policy batch of 256 per data rank, 3 members per model rank."""
    envs = 10 * data_parallel
    return BASE_ARGS + [
        "--data_parallel", str(data_parallel), "--model_parallel", str(model_parallel),
        "--num_envs", str(envs),
        "--num_dynamics_models", str(3 * model_parallel),
        "--num_elite_models", str(3 * model_parallel),
        "--model_rollouts_batch_size", str(100 * data_parallel),
        "--policy_batch_size", str(256 * data_parallel),
        "--total_timesteps", str(WARMUP + ITERATIONS * envs),
        "--surrogate_train_freq", str(3 * envs),
        "--run_dir", run_dir,
    ]


def k1_launches(num_envs: int) -> int:
    """K1's launches on every rank and at 1x1: the reset pool, the two
    evaluations, the warmup's steps and one collect step per iteration."""
    return OTHER_LAUNCHES + WARMUP // num_envs + ITERATIONS


# --------------------------------------------------------------- checks
def iteration_walls(records: Sequence[Dict]) -> List[float]:
    """Each iteration's wall time: the gaps of its record's ``time``."""
    times = [r["time"] for r in records]
    return [round(b - a, 3) for a, b in zip([0.0] + times, times)]


def dispatch_to_pull(rec: Dict) -> float:
    """A non-retrain iteration's seconds from its dispatch to its results on
    the host: ``t_dispatch`` + ``t_ready`` of the fused iteration (whose
    ``t_ready`` spans the next iteration's dispatch), its ``t_fused`` on an
    evaluation iteration, else the sum of its synchronised phases."""
    if "t_ready" in rec:
        return round(rec["t_dispatch"] + rec["t_ready"], 4)
    if "t_fused" in rec:
        return rec["t_fused"]
    return round(sum(rec[k] for k in ("t_collect", "t_imagine", "t_policy", "t_pull")), 4)


def finite_records(path: str) -> List[Dict]:
    """The records of ``path``; every ``FINITE`` key logged, and finite."""
    if not os.path.exists(path):
        raise AssertionError(f"{path} was not written")
    records = dryrun.metrics_lines(os.path.dirname(path))
    for k in FINITE:
        vals = [r[k] for r in records if k in r]
        if not vals or not all(isinstance(v, (int, float)) and math.isfinite(v) for v in vals):
            raise AssertionError(f"{k}: {vals}")
    return records


def hold_one(mesh_recs: Sequence[Dict], one_recs: Sequence[Dict]
             ) -> Tuple[List[str], Dict[Tuple[bool, str], Tuple[float, int]]]:
    """Hold a mesh's stream to 1x1's: the same records and keys, every
    value finite, and iteration 0 within rtol 2e-4 / atol 1e-7 on
    ``MESH_KEYS`` up to its SAC updates.  Returns the keys held and, for
    the rest, the largest relative gap and its iteration, keyed by (later
    than iteration 0, key)."""
    if len(mesh_recs) != len(one_recs) or len(mesh_recs) != ITERATIONS:
        raise AssertionError(f"{len(mesh_recs)} records on the mesh, {len(one_recs)} at 1x1")
    worst: Dict[Tuple[bool, str], Tuple[float, int]] = {}
    for a, b in zip(mesh_recs, one_recs):
        for k in MESH_KEYS:
            if (k in a) != (k in b):
                raise AssertionError(f"iteration {a['iteration']}: {k} in one stream only")
            if k not in a:
                continue
            va, vb = np.asarray(a[k], float), np.asarray(b[k], float)
            if not np.isfinite(va).all():
                raise AssertionError(f"iteration {a['iteration']}: {k} = {a[k]}")
            gap = float(np.max(np.abs(va - vb) / np.maximum(np.abs(vb), 1e-12)))
            later = a["iteration"] > 0
            if later or k in MESH_AFTER_SAC:
                if gap >= worst.get((later, k), (0.0,))[0]:
                    worst[later, k] = (gap, a["iteration"])
            elif not np.allclose(va, vb, rtol=2e-4, atol=1e-7):
                raise AssertionError(f"iteration 0: {k} {a[k]} on the mesh, {b[k]} at 1x1")
    held = [k for k in MESH_KEYS if k in mesh_recs[0] and k not in MESH_AFTER_SAC]
    return held, worst


def sac_reorder_gaps(updates: int = 200, batch: int = 512) -> Dict[str, float]:
    """The relative gaps of the last of ``updates`` float32 SAC updates of
    the flagship's agent (64-point obs, 4 jets, hidden 256) on the card
    when each batch's rows come in reverse order: the same arithmetic in
    another summation order, in one process."""
    import copy

    from pdecontrol_tpu_torch.data.types import Sample
    from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig

    dev = torch.device("cuda")
    torch.manual_seed(0)
    sac = SAC((1, 64), (1, 4), SACConfig(), device=dev)
    start = sac.init()
    gen = torch.Generator(device=dev).manual_seed(1)

    def draw(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    batches = [(Sample(obs=draw(batch, 1, 64) * 2 - 1, actions=draw(batch, 1, 4) * 2 - 1,
                       nxtobs=draw(batch, 1, 64) * 2 - 1, rewards=-draw(batch),
                       terminated=torch.zeros(batch, dtype=torch.bool, device=dev),
                       truncated=torch.zeros(batch, dtype=torch.bool, device=dev),
                       steps=torch.zeros(batch, dtype=torch.int32, device=dev)),
                (torch.randn((batch, 1, 4), generator=gen, device=dev),
                 torch.randn((batch, 1, 4), generator=gen, device=dev)))
               for _ in range(updates)]
    out = []
    for rows in (torch.arange(batch, device=dev), torch.arange(batch, device=dev).flip(0)):
        state = copy.deepcopy(start)
        for sample, noise in batches:
            state, m = sac.update(state, sample.apply(lambda x: x[rows]),
                                  noise=tuple(x[rows] for x in noise))
        out.append({k: float(m[k]) for k in ("qf_loss", "policy_loss")})
    return {f"sac_{k}": abs(out[1][k] - out[0][k]) / abs(out[0][k]) for k in out[0]}


# ------------------------------------------------------------ rank mode
def time_mean(mesh, device: torch.device, reps: int = 20) -> Dict:
    """One ``mean_`` over ``data`` of the flagship critic's float32
    gradients (64-point obs, 4 jets, hidden 256), eagerly
    (``dryrun_mp.time_critic_allreduce``) and replayed from a CUDA graph:
    milliseconds per call from the host clock around ``reps`` calls, each
    ending in a device synchronisation, and whether the replay equals the
    eager call bit for bit."""
    from pdecontrol_tpu_torch.parallel.dryrun_mp import time_critic_allreduce
    from pdecontrol_tpu_torch.parallel.mesh import DATA_AXIS
    from pdecontrol_tpu_torch.sac.nets import QNetwork
    from pdecontrol_tpu_torch.utils.graphs import GraphCache

    eager = time_critic_allreduce(mesh, device, reps)
    gen = torch.Generator(device=device).manual_seed(100 + mesh.rank)
    grads = [torch.randn(p.shape, generator=gen, device=device)
             for p in QNetwork(64 + 4, hidden=256).to(device).parameters()]
    inputs = [g.clone() for g in grads]
    want = [g.clone() for g in grads]
    mesh.mean_(want, DATA_AXIS)
    cache = GraphCache([])

    def once():
        cache.run("mean_", lambda: mesh.mean_(grads, DATA_AXIS), lambda: grads, "mean_")
        torch.cuda.synchronize(device)

    once()  # eagerly, then the capture
    for g, x in zip(grads, inputs):
        g.copy_(x)
    once()  # the first replay
    equal = all(torch.equal(g, w) for g, w in zip(grads, want))
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    return {"eager_ms": eager["ms"], "graph_ms": 1e3 * (time.perf_counter() - t0) / reps,
            "bytes": eager["bytes"], "graph_equals_eager": equal}


def rank_main(script_argv: Sequence[str], graphs: bool,
              stacks_after: Optional[float] = None) -> int:
    """One process of a route: ``mbrl.script``'s arguments, a rank of a
    mesh where they name a coordinator, else 1x1; its controller built with
    ``graphs``.  Prints ``mbrl.script``'s ``[rank]`` line with the time of
    one ``mean_`` (``time_mean``) under a mesh.  If it still runs after
    ``stacks_after`` seconds, the stacks of its threads go to its stderr."""
    import faulthandler

    from pdecontrol_tpu_torch.mbrl import script
    from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
    from pdecontrol_tpu_torch.parallel import distributed

    if stacks_after:
        faulthandler.dump_traceback_later(stacks_after)

    args = script.build_parser().parse_args(list(script_argv))
    config = script.config_from_args(args)
    device = script.platform_device(args.platform)
    if args.coordinator_address:
        device = distributed.initialize(args.coordinator_address, args.num_processes,
                                        args.process_id, args.platform)
    try:
        ctl = PDEModelBasedController(config, device=device, graphs=graphs)
        try:
            ctl.learn()
        finally:
            ctl.logger.finish()
        report = json.loads(script.rank_report(ctl)[len("[rank] "):])
        if ctl.mesh is not None and ctl.device.type == "cuda":
            report["mean_"] = time_mean(ctl.mesh, ctl.device)
        print("[rank] " + json.dumps(report), flush=True)
        return 0
    finally:
        distributed.shutdown()


def nccl_world_of_one(reps: int = 3) -> Dict:
    """A process group of one NCCL rank on card 0 (NCCL refuses two ranks on
    one card, so this is the capture route of ProcessGroupNCCL that one
    card can run): a body that calls ``dist.all_reduce`` is run eagerly and
    captured through ``GraphCache``, then replayed ``reps`` times, each on
    fresh inputs and held bit for bit to an eager call of the body on the
    same inputs."""
    import torch.distributed as dist

    from pdecontrol_tpu_torch.parallel import distributed
    from pdecontrol_tpu_torch.utils.graphs import GraphCache

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{dryrun.free_port()}",
                            world_size=1, rank=0)
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.empty((1 << 16,), device=dev)
        y = torch.empty_like(x)

        def body():
            y.copy_(x * 3 + 1)
            dist.all_reduce(y)
            return y * 2

        cache = GraphCache([])
        x.normal_(generator=gen)
        cache.run("all_reduce", body, lambda: [x, y], "the all_reduce")  # eager, then the capture
        equal = []
        for _ in range(reps):
            x.normal_(generator=gen)
            want = body().clone()
            got = cache.run("all_reduce", body, lambda: [x, y], "the all_reduce")
            torch.cuda.synchronize(dev)
            equal.append(bool(torch.equal(got, want)))
        graph = cache.get("all_reduce")
        return {"backend": dist.get_backend(), "device": str(dev), "world_size":
                dist.get_world_size(), "captured": graph is not None, "replays": reps,
                "equal": equal, "t_capture": round(graph.seconds, 4)}
    finally:
        distributed.shutdown()


# ------------------------------------------------------- the four-card run
def rank_command(route: str, argv: Sequence[str], stacks_after: float) -> List[str]:
    """One process of ``route`` (``rank_main``) with ``mbrl.script``'s
    arguments ``argv``."""
    cmd = [sys.executable, "-m", "pdecontrol_tpu_torch.parallel.mesh_smoke", "rank",
           "--stacks_after", str(stacks_after)]
    cmd += ["--eager"] if route == "eager" else []
    cmd += ["--", *argv]
    return cmd + (["--no_fuse_iteration"] if route == "no_fuse_iteration" else [])


def rank_lines(outs: Sequence[str]) -> List[Dict]:
    return [json.loads(next(line[len("[rank] "):] for line in out.splitlines()
                            if line.startswith("[rank] "))) for out in outs]


def launch_route(name: str, route: str, base: str, timeout: float, env: Dict[str, str]
                 ) -> Tuple[List[Dict], float]:
    """The ranks of ``route`` on the layout ``name``, each in a run directory
    under ``base``; returns their ``[rank]`` lines and the launch's seconds."""
    dp, mp, _ = LAYOUTS[name]
    logs = os.path.join(base, "logs")
    os.makedirs(logs)
    address = f"localhost:{dryrun.free_port()}"
    cmds = [rank_command(route, mesh_args(dp, mp, os.path.join(base, f"rank{i}")) + [
        "--coordinator_address", address, "--num_processes", str(dp * mp),
        "--process_id", str(i)], timeout - 30) for i in range(dp * mp)]
    t = time.perf_counter()
    ranks = rank_lines(dryrun.launch(cmds, timeout, logs, env=env))
    return ranks, time.perf_counter() - t


def check_ranks(name: str, route: str, ranks: Sequence[Dict]) -> None:
    dp, _, _ = LAYOUTS[name]
    envs = 10 * dp
    for r in ranks:
        if (r["backend"], r["device"]) != ("nccl", f"cuda:{r['rank']}"):
            raise AssertionError(f"{name} {route}: rank {r['rank']} ran on {r['device']} "
                                 f"through {r['backend']}")
        graphs = r["graphs"]
        kinds = {k[0] for k in graphs.get("phases", {}).get("keys", [])}
        if route == "eager" and graphs:
            raise AssertionError(f"{name} eager: rank {r['rank']} captured {graphs}")
        if route != "eager" and not (PHASE_KINDS <= kinds and "fit" in graphs):
            raise AssertionError(f"{name} {route}: rank {r['rank']} captured {graphs}")
        if (route == "default") != ("fused" in graphs):
            raise AssertionError(f"{name} {route}: rank {r['rank']} captured {graphs}")
        if not r["mean_"]["graph_equals_eager"]:
            raise AssertionError(f"{name} {route}: rank {r['rank']}: a replayed mean_ "
                                 f"differs from its eager call")
        per = (r["K1_rows"] - OTHER_ROWS) / (r["K1"] - OTHER_LAUNCHES)
        if r["K1"] != k1_launches(envs) or per != envs // dp:
            raise AssertionError(f"{name} {route}: rank {r['rank']} launched K1 {r['K1']} "
                                 f"times at {per} rows per collect launch, expected "
                                 f"{k1_launches(envs)} at {envs // dp}")


def nccl_choices(logdir: str) -> List[str]:
    """The distinct algorithm and protocol choices NCCL logged under
    ``NCCL_DEBUG_SUBSYS=TUNING`` in ``logdir``, one line each."""
    seen = set()
    for f in sorted(os.listdir(logdir)):
        if f.startswith("nccl."):
            for line in open(os.path.join(logdir, f), errors="replace"):
                if "NCCL INFO" in line and ("Algo" in line or "algo" in line):
                    seen.add(line.split("NCCL INFO", 1)[1].strip())
    return sorted(seen)


def diagnose_nccl(name: str, routes: Sequence[str], out: str, timeout: float,
                  env: Dict[str, str]) -> None:
    """After the routes' streams differ: run them again with NCCL's tuning
    log on and print the algorithm and protocol choices in which they
    differ."""
    choices = {}
    for route in routes:
        base = os.path.join(out, name + "_nccl_log", route)
        logs = os.path.join(base, "logs")
        launch_route(name, route, base, timeout, dict(
            env, NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="TUNING",
            NCCL_DEBUG_FILE=os.path.join(logs, "nccl.%h.%p.log")))
        choices[route] = set(nccl_choices(logs))
        print(f"[mesh_smoke] {name} {route}: {len(choices[route])} distinct NCCL choices",
              flush=True)
    first = choices[routes[0]]
    for route in routes[1:]:
        for line in sorted(first ^ choices[route])[:40]:
            print(f"[mesh_smoke]   {routes[0] if line in first else route} only: {line}",
                  flush=True)


def run_layout(name: str, out: str, timeout: float, env: Dict[str, str]) -> Dict:
    """Every route of the layout ``name`` on four ranks, one after another,
    each held as the module's docstring says; returns what was measured."""
    dp, mp, routes = LAYOUTS[name]
    result = {"routes": {}}
    streams = {}
    for route in routes:
        base = os.path.join(out, name, route)
        ranks, wall = launch_route(name, route, base, timeout, env)
        print(f"[mesh_smoke] {name} {route}: {dp * mp} ranks in {wall:.1f} s (start-up "
              f"included)", flush=True)
        for r in ranks:
            g = r["graphs"]
            print(f"[mesh_smoke]   rank {r['rank']} {r['device']} {r['backend']}: captures "
                  + (", ".join(f"{k} {len(v['keys'])} in {v['t_capture']:.2f} s, pool "
                               f"+{v['graph_pool_mb']:.1f} MB" for k, v in g.items())
                     or "none")
                  + f"; t_fit_total {r['t_fit_total']} s; K1 {r['K1']} launches of "
                  f"{r['K1_rows']} rows; peak {r['peak_allocated_mb']} MB; mean_ "
                  f"{r['mean_']['eager_ms']:.3f} ms eagerly, {r['mean_']['graph_ms']:.3f} ms "
                  f"replayed ({r['mean_']['bytes']} bytes)", flush=True)
        recs = finite_records(os.path.join(base, "rank0", "metrics.jsonl"))
        retrain = {r["iteration"] for r in recs if "t_fit_total" in r}
        res = result["routes"][route] = {
            "ranks": ranks, "wall_s": round(wall, 2),
            "iteration_walls": iteration_walls(recs),
            "non_retrain_dispatch_to_pull": {r["iteration"]: dispatch_to_pull(r)
                                             for r in recs if r["iteration"] not in retrain},
        }
        print(f"[mesh_smoke]   iteration walls {res['iteration_walls']} s; non-retrain "
              f"dispatch to pull {res['non_retrain_dispatch_to_pull']} s", flush=True)
        check_ranks(name, route, ranks)
        files = sorted(os.listdir(os.path.join(base, "rank0")))
        others = [i for i in range(1, dp * mp) if os.path.exists(os.path.join(base, f"rank{i}"))]
        if not {"metrics.jsonl", "config.json", "checkpoints"} <= set(files) or others:
            raise AssertionError(f"{name} {route}: the primary wrote {files}; ranks {others} "
                                 f"wrote a run directory")
        streams[route] = recs
    first = [dryrun.strip_timing(r) for r in streams[routes[0]]]
    for route in routes[1:]:
        other = [dryrun.strip_timing(r) for r in streams[route]]
        if other != first:
            diff = [(a["iteration"], k, a.get(k), b.get(k)) for a, b in zip(first, other)
                    for k in sorted(a.keys() | b.keys()) if a.get(k) != b.get(k)]
            print(f"[mesh_smoke] {name}: {route}'s stream differs from {routes[0]}'s: "
                  f"{diff[:12]}", flush=True)
            diagnose_nccl(name, (routes[0], route), out, timeout, env)
            raise AssertionError(f"{name}: {route}'s stream differs from {routes[0]}'s")
    fields = sum(len(r) for r in first)
    print(f"[mesh_smoke] {name}: the {len(routes)} routes' streams equal bit for bit in "
          f"{fields} non-clock fields", flush=True)
    result["equal_fields"] = fields
    result["streams"] = streams
    return result


def run(out: str, timeout: float) -> Dict:
    count = torch.cuda.device_count()
    if count < 4:
        raise RuntimeError(f"the mesh smoke test needs four NVIDIA cards, found {count}")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    for i, line in enumerate(cards):
        print(f"[mesh_smoke] card {i}: {line}", flush=True)
    print(f"[mesh_smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    os.makedirs(out)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    summary = {"cards": cards}

    # b and c, the default route first.
    layouts = {name: run_layout(name, out, timeout, env) for name in LAYOUTS}

    # 1x1 of both layouts' arguments, at once, on cards 0 and 1.
    t = time.perf_counter()
    logs = os.path.join(out, "one", "logs")
    os.makedirs(logs)
    cmds = [["env", f"CUDA_VISIBLE_DEVICES={i}", *rank_command(
        "default", mesh_args(dp, mp, os.path.join(out, "one", name)) + [
            "--data_parallel", "1", "--model_parallel", "1"], timeout - 30)]
        for i, (name, (dp, mp, _)) in enumerate(LAYOUTS.items())]
    ones = dict(zip(LAYOUTS, rank_lines(dryrun.launch(cmds, timeout, logs, env=env))))
    print(f"[mesh_smoke] 1x1 of both layouts' arguments in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name, (dp, _, _) in LAYOUTS.items():
        r = ones[name]
        per = (r["K1_rows"] - OTHER_ROWS) / (r["K1"] - OTHER_LAUNCHES)
        if r["K1"] != k1_launches(10 * dp) or per != 10 * dp:
            raise AssertionError(f"1x1 of {name}: K1 {r['K1']} launches at {per} rows per "
                                 f"collect launch")
        result = layouts[name]
        one = finite_records(os.path.join(out, "one", name, "metrics.jsonl"))
        held, worst = hold_one(result.pop("streams")["default"], one)
        print(f"[mesh_smoke] {name}: iteration 0 agrees with 1x1 on {', '.join(held)} "
              f"(rtol 2e-4, atol 1e-7)", flush=True)
        result["one"] = {"rank": r, "iteration_walls": iteration_walls(one)}
        result["after_sac_gap"] = {k: g for (later, k), (g, _) in worst.items() if not later}
        result["later_gap"] = {k: v for (later, k), v in worst.items() if later}
        print(f"[mesh_smoke] {name}: iteration 0 after its SAC updates, relative gap to 1x1: "
              f"{result['after_sac_gap']}; iterations 1-5, largest relative gap (not held): "
              f"{result['later_gap']}; 1x1 iteration walls {result['one']['iteration_walls']} s",
              flush=True)
        summary[name] = result

    # a. The dry run.
    t = time.perf_counter()
    recs = dryrun.run(4, None, timeout)
    for r in recs:
        if (r["backend"], r["device"]) != ("nccl", f"cuda:{r['rank']}"):
            raise AssertionError(f"dry run: rank {r['rank']} on {r['device']} through "
                                 f"{r['backend']}")
    summary["dryrun"] = {"s": round(time.perf_counter() - t, 2),
                         "critic_mean_ms": [r["sac"]["critic_allreduce"]["ms"] for r in recs]}
    summary["sac_reorder_gaps"] = sac_reorder_gaps()
    print(f"[mesh_smoke] one process reversing the rows of each SAC batch: "
          f"{summary['sac_reorder_gaps']}", flush=True)
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["one"]:  # chip_smoke.py's phase 18, on one card
        print(json.dumps(nccl_world_of_one()), flush=True)
        return 0
    if argv[:1] == ["rank"]:  # one process of a route (``rank_command``)
        split = argv.index("--")
        p = argparse.ArgumentParser(prog="mesh_smoke rank")
        p.add_argument("--eager", action="store_true")
        p.add_argument("--stacks_after", type=float, default=None)
        opts = p.parse_args(argv[1:split])
        return rank_main(argv[split + 1:], graphs=not opts.eager,
                         stacks_after=opts.stacks_after)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=os.path.join(dryrun.repo_root(), "runs", "mesh_smoke"),
                   help="a directory that does not exist yet, for the runs and their logs")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="wall-clock limit of every launch of processes, in seconds")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    summary = run(args.out, args.timeout)
    summary["s"] = round(time.perf_counter() - t0, 2)
    print(f"[mesh_smoke] every check passed in {summary['s']:.1f} s", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
