#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Twenty-three phases, each timed:

  1. build — compile kernels K1 (``pdecontrol_tpu_torch/csrc/
     ks_control_period.cu``) and K2 (``csrc/ks_control_period_limb.cu``)
     from the checkout's sources, one nvcc for each, started together, and
     print what ptxas reports of each kernel's registers and spills;
  2. K1 against its plain PyTorch version on the card, float32, both
     objectives: 20 sub-steps at batch 12, 8 and 64 on grids of 32, 64 and
     128 points (rtol 2e-5, atol 2e-6, the tolerance of
     ``tests/test_pallas_ks.py``); 3 periods x 25 sub-steps through
     ``env.step`` at batch 8 and for one unbatched [64] state (rtol 3e-5,
     atol 3e-6, ``tests/test_env_solvers.py``); one full 250-sub-step period
     at batch 10, 64, 100 and 1024, the batches of the paths below (max abs
     error printed, held to rtol 1e-4, atol 1e-5); then the reset pool's
     set-up time (920 K1 launches at batch 64), and K1's time per period at
     the same four batches (CUDA events), beside the plain version's time
     and the roofline bound; then K1's general path (every grid of 9 to
     1,024 points but 32, 64, ..., 256; see ``check_kernel_grids``) against
     the plain version on the host's CPU at 9 to 1,024 points and batch 1,
     12 and 64, ``env.step`` at 48 points, 8 and 1,025 points refused
     before a launch, and its time per period at 48 and 512 points;
  3. the main path — ``pdecontrol_tpu_torch.mbrl.script.main`` with the
     flagship arguments of ``runscripts/mbpo_ks.sh`` and ``--solver pallas``
     for a few iterations (see ``MAIN_ARGS``), by default: every iteration
     that does not retrain replays the CUDA graph of the fused iteration,
     captured at iteration 1, and its record carries the fused fields
     (``t_dispatch`` and ``t_ready``, ``t_capture`` where it captured); a
     retrain iteration replays a graph of each phase (collect, imagine,
     the SAC updates) and of each evaluation, captured at their first
     call, and its record carries the captures made since the previous
     one (``t_capture``, ``graph_pool_mb``); the retrains' ``t_imagine``,
     ``t_policy`` and ``t_eval`` and the path's peak memory are printed;
     the phase checks K1's launch count (replays included),
     that every logged loss and return is finite, that ``metrics.jsonl``
     exists, that ``checkpoints/`` holds the steps 2, 4 and 6, and that the
     evaluation artifacts of iteration 0 (and, where the host has matplotlib
     and PIL, the plots) were written;
  4. K2 (one warp per row, the limbs' halo by warp shuffles) against its
     plain PyTorch version on the card (see ``check_limb_kernel``), for
     ``bf16``, ``bf16_3x`` and ``bf16_4x`` and both objectives, on smooth
     fields on grids of 32 to 256 points (one-pass ``bf16`` up to 128);
     then K2's and the plain version's time per period for ``bf16_3x`` at
     batch 10, 64 and 1024 and for ``bf16_4x`` at batch 10, beside the
     roofline bound; then K2's general path in every limb mode at 16 to
     512 points (``check_limb_kernel_grids``), as phase 2 holds K1's;
  5. the attractor gate (``pdecontrol_tpu_torch.evaluation.bf16_gate``):
     first the float32 side's rollout at 64 envs x (10 + 20) periods with
     each period replayed from its CUDA graph against the same rollout
     eagerly, bitwise, both timed; then at full size: one float32 run of
     512 envs x 400 periods after 100, compared with a ``bf16_3x`` and a
     ``bf16_4x`` run, every period a replay; both verdicts must pass, and
     each error is printed beside the TPU receipt's
     (``results/bf16_fidelity_{3x,4x}.json``);
  6. the bf16_3x MBPO path — ``MAIN_ARGS`` with ``--solver pallas_packed``
     and ``pallas_precision`` bf16_3x (``runscripts/mbpo_ks_bf16.sh``), and
     an evaluation at iteration 5 as well, which runs on the fused route
     (``t_fused``); checked as phase 3, and K2 must have launched;
  7. the model-free SAC baseline CLI (``pdecontrol_tpu_torch.sac.train``)
     through K2 for 5,000 env steps, every chunk after the first replaying
     its CUDA graph; K2 must have launched and every logged loss and return
     must be finite; then two trainers of the same arguments, one built
     with ``graphs=False``, from one state: three chunks of 100 env steps
     and two evaluations each, which must be equal bitwise, and both
     routes' env steps per second;
  8. restart: a new controller built from phase 3's arguments with
     ``--resume`` and two more iterations' worth of steps must restore
     iteration 6 with phase 3's counters, run iterations 6 and 7 without a
     warmup and append them to phase 3's ``metrics.jsonl``; then one
     ``save_checkpoint()`` of the full-size state is timed (the seconds
     until ``save()`` returns, until the file is on disk, and its size);
  9. trace: the main path cut to iterations 0 and 1 with ``--profile_dir``;
     the trace file and the spans file beside it must exist, the trace must
     show the program's spans on its host rows and the stamp kernel on its
     device rows, and its size, the wall time of the traced
     iteration (one replay of the graph, captured before the trace starts)
     and the share of it in which CUDA kernels ran are printed (and the same
     kernel time against phase 3's iteration 1, from its dispatch to its
     record's pull);
 10. the latent path — ``runscripts/mbpo_ks_latent_r4.sh``: the main path
     with ``--factory KSLatentConvolutionalLSTM`` and that script's
     ``--trainer`` and ``--training`` (see ``LATENT_ARGS``), checked as
     phase 3; K1 must launch as often as on the main path;
 11. the Burgers path — ``runscripts/mbpo_burgers.sh`` (``--env_id
     BurgersEnv-v0 --reward_scale 500``; see ``BURGERS_ARGS`` for the cuts),
     checked as phase 3; the Burgers solver is plain PyTorch, so neither
     kernel may launch, and the seconds per env step are printed;
 12. offline — ``pdecontrol_tpu_torch.evaluation.generate`` writes the
     dataset of ``runscripts/offline.sh`` (KS, 100 episodes of 400 steps,
     through K1), then ``pdecontrol_tpu_torch.evaluation.evaluate`` runs
     ``runscripts/capacity.sh``'s arguments for each of the five factories,
     cut to one fold and two epochs, its TBPTT and validation steps replayed
     from CUDA graphs; each fold's ``MSE``, ``nrmse_final`` and
     ``val_loss`` must be finite and its npz must hold the metric battery's
     keys; one line per factory gives the train steps, the seconds per
     TBPTT step and the ``MSE``; then the first factory's fold again,
     graphed and eagerly: results and metric arrays equal bitwise, and both
     routes' seconds per TBPTT step;
 13. the routes — ``MAIN_ARGS`` with ``--no_fuse_iteration`` (every
     iteration runs its phases one after another, each a replayed CUDA
     graph timed after a synchronisation), and the same arguments in a
     controller built with ``graphs=False`` (every phase and the fit
     eager): K1 must launch as in phase 3 in both, and the 6 records of each
     must equal phase 3's in every field that does not read the clock.  The
     three routes' non-retrain iteration wall times and the two unfused
     routes' phase times are printed.  Then the cost of the world step's
     auto-reset, on phase 8's controller: ``imagine`` at horizon 3 with
     the port's form (a reset drawn at every step but a round's last; in a
     graph its rollout in a conditional node that runs only where the batch
     is done), a select form (the same draws, the fresh state computed at
     every step and picked on the card, as JAX's ``lax.select``) and a
     host-read form (the host reads whether the batch is done and resets
     only then), eagerly and, for the two that need no host read, as a
     replayed CUDA graph;
 14. lock-step fit against one-after-another — phase 3's last snapshot
     (iteration 6) restored into a controller of each fit route, each of
     which retrains once at the flagship's ``iterations`` trainer config
     (patience 5, ``min_steps`` 50) cut to ``max_steps`` 50:
     ``--sequential_member_training`` (one member after another, each step
     a replayed graph), the same with ``--no_fuse_fit`` (eager),
     ``--no_fuse_fit`` and the default; each route's ``t_fit_total``, its
     seconds per lock-step step and per member-step, the graphed routes'
     capture time and pool growth, and the share of computed member-steps
     that belonged to members already stopped are printed; the default
     route's parameters, Adam state and val losses must equal
     ``--no_fuse_fit``'s exactly, and the graphed sequential route's its
     eager run's;
 15. native — the C++ host solver (``pdecontrol_tpu_torch/utils/native.py``,
     built from ``native/ks_solver.cc`` into ``build/native/``) against K1
     over one 250-sub-step period at batch 10, both objectives, in float64
     (rtol 1e-4, atol 1e-5), and its time per period on one core beside
     K1's (phase 2);
 16. the dry run on the card — ``python -m pdecontrol_tpu_torch.parallel.dryrun
     4``: four ranks on the card through gloo, every stage (see that
     module) on the JAX dry run's 16-point grid, and the time of one
     average of the flagship critic's gradients over ``data``;
 17. the mesh — ``runscripts/mbpo_ks_mesh.sh``'s arguments at
     ``DATA_PARALLEL=2 MODEL_PARALLEL=2`` (20 envs, 6 members, rollout batch
     200, policy batch 512) cut as phase 3 (see ``MESH_ARGS``), as four
     ``pdecontrol_tpu_torch.mbrl.script`` processes on the card, each rank
     in a run directory of its own, and the same arguments at 1x1 in this
     process: the replay of the random warmup must equal the 1x1 run's
     bitwise, iteration 0's record must agree on the JAX package's keys
     up to its SAC updates (rtol 2e-4, atol 1e-7), the later ones must be
     finite with the same keys (their largest gap is printed), every rank
     must launch K1 as often as the 1x1 run at half its rows per collect
     launch, and only the primary may write files; each rank's device, backend and peak memory
     and both runs' iteration wall times are printed.  Iteration 0's keys
     that follow its 200 float32 SAC updates (their losses, the evaluation)
     are printed beside the gap that one process makes by reversing the
     rows of each SAC batch (``sac_reorder_gaps``), not held.  Through gloo
     every rank replays the lock-step fit's graphs (each rank's
     ``t_fit_capture``, ``fit_graph_pool_mb`` and last ``t_fit_total`` are
     printed) and runs the fused iteration's phases, the phases and the
     evaluations eagerly, since gloo's collectives run on the host
     (``controller.graph_routes``); ``parallel/mesh_smoke.py`` runs the same
     arguments on four cards through NCCL, every route graphed;
 18. one NCCL rank — a process group of world size 1 on the card (NCCL
     refuses two ranks on one card): a body that calls
     ``dist.all_reduce`` is captured through ``GraphCache`` and replayed 3
     times on fresh inputs, each replay equal to the eager body bit for
     bit (``mesh_smoke.py one``);
 19. what only a long run reaches — ``MAIN_ARGS`` for 10 iterations with
     the horizon climbing from 3 to 7 (two iterations a horizon), a world
     replay of 2 iterations' rollouts that wraps in iteration 2, and a
     trainer whose ``max_steps`` lie above ``min_steps`` with patience 2 /
     1 (see ``LONG_ARGS``), on three routes: the default, ``--no_fuse_iteration
     --no_fuse_fit`` and a controller built with ``graphs=False``.  Every
     route must launch K1 ``LONG_K1_LAUNCHES`` times and run the horizons
     of the schedule; the default route must capture and replay a fused
     graph for each of the horizons 3-7 and replay the fit's graphs, the
     second a ``("world", horizon, rounds)`` graph for each; each route's
     world replay must pass its ``num_rows`` (its ``next_row`` is
     printed); the other two routes' streams must equal the default's in
     every non-clock field, and their steps per member at each retrain
     and their members' parameters and Adam state after the run (the
     graphed fit against ``--no_fuse_fit``) the default's exactly; at one
     retrain at least a member must stop before the others, and each
     retrain's share of masked member-steps is printed, as is the default
     route's dispatch to pull by horizon;
 20. the dissipation channel — ``MAIN_ARGS`` with ``runscripts/
     mbpo_ks_dissipation.sh``'s ``{"objective": ""}`` (the reference quirk
     that selects the dissipation + power integrand) for phase 3's six
     iterations, checked as phase 3: K1 must launch ``MAIN_K1_LAUNCHES``
     times and K2 never, and the run's config must carry the objective;
 21. the twin on the card — ``tests/twin_tape.py``'s tiny ``learn()`` (the
     twin that ``tests/test_torch_twin.py`` holds to the JAX package in
     float64 on the CPU) in float32 on one tape of draws, on the card
     through K1 in a controller built with ``graphs=False`` (a graph would
     replay its capture's draws) and, in a process of its own, on the
     host's CPU through the plain solver.  The float32 floor adds three
     gaps from the CPU run, each field's own: the CPU run with each SAC
     batch's rows in reverse order (summation order), the CPU run with
     every control period moved by +-phase 2's K1 error (K1's gap to the
     plain version), and the card's run through the plain solver.  The
     card's K1 run must start from the CPU run's weights and hold the
     warmup's rewards, the first retrain's ``val_loss``, ``elite_scores``,
     ``epochs`` and ``steps`` and the first evaluation within the floor;
     the largest gap of every iteration's record and the first iteration
     that parts beyond its floor are printed, and not held;
 22. other grids — ``MAIN_ARGS`` at 48 points (``--env_config '{"n":
     48}'``, K1's general path) and at 512 points on eight times the domain
     (``{"n": 512, "length": 176.0, "pallas_precision": "bf16_3x"}`` with
     ``--solver pallas_packed``, K2's general path and K1's for the reset
     transient), each checked as phase 3 and held to the launch counts
     predicted in ``GRID_RUNS``, printed beside them;
 23. the latent and Burgers twins on the card — ``tests/twin_tape.py``'s
     ``latent`` (``runscripts/mbpo_ks_latent_r4.sh``'s structure:
     ``KSLatentConvolutionalLSTM``, re-encoding world steps) and
     ``burgers`` (``runscripts/mbpo_burgers.sh``'s: ``BurgersEnv-v0``,
     rewards scaled by 500) tapes, each held as phase 21 holds the
     flagship's, whose twins ``tests/test_torch_twin_latent.py`` and
     ``tests/test_torch_twin_burgers.py`` hold to the JAX package in
     float64.  The latent tape runs through K1 on 32 points (the register
     path) and must launch it ``TWIN_K1_LAUNCHES["latent"]`` times; its
     floor is phase 21's.  The Burgers tape runs on the card alone (it
     has one solver, plain PyTorch) and must launch neither kernel; its
     floor adds two gaps from the CPU run: SAC rows reversed, and every
     control period moved by +-the gap of one Burgers period on the card
     from the same period on the host's CPU over the twin's reset pool
     (at least one float32 ulp of the pool's largest value).

Every retrain of the MBPO paths (phases 3, 6 and 8 to 11, 13, 19, 20 and 22)
runs the default lock-step fit, its TBPTT and validation steps replayed from
CUDA graphs: each retrain record must carry that route's fields
(``t_fit_prep``, ``t_fit_dispatch``, ``t_fit_ready``), and each run's first
retrain the fit's captures (``t_fit_capture``); the controllers of phases
13 and 19 built with ``graphs=False`` fit eagerly, and phase 19's
``--no_fuse_fit`` route too (``t_fit_val`` in place of ``t_fit_ready``).

Every path of phases 3, 6 to 13, 17, 19 to 23 runs with the kernels' launch counts
set to 0 just before it, and they are read just after it (a rank process of
phase 17 starts at 0 and prints its counts at its end); K1 runs the
reset-pool transient of every KS path.  The script prints the card's name and power
limit, the whole script's seconds, one JSON line describing the kernels,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, or when any phase fails, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(HERE, "runs", "chip_smoke")
RUN_DIR_BF16 = os.path.join(HERE, "runs", "chip_smoke_bf16")
RUN_DIR_SAC = os.path.join(HERE, "runs", "chip_smoke_sac")
RUN_DIR_TRACE = os.path.join(HERE, "runs", "chip_smoke_trace")
RUN_DIR_LATENT = os.path.join(HERE, "runs", "chip_smoke_latent")
RUN_DIR_BURGERS = os.path.join(HERE, "runs", "chip_smoke_burgers")
RUN_DIR_OFFLINE = os.path.join(HERE, "runs", "chip_smoke_offline")
RUN_DIR_EAGER = os.path.join(HERE, "runs", "chip_smoke_eager")
RUN_DIR_NO_GRAPHS = os.path.join(HERE, "runs", "chip_smoke_no_graphs")
RUN_DIR_SAC_ROUTES = os.path.join(HERE, "runs", "chip_smoke_sac_routes")
RUN_DIR_FIT = os.path.join(HERE, "runs", "chip_smoke_fit")
RUN_DIR_MESH = os.path.join(HERE, "runs", "chip_smoke_mesh")
RUN_DIR_MESH_ONE = os.path.join(HERE, "runs", "chip_smoke_mesh_1x1")
RUN_DIR_LONG = os.path.join(HERE, "runs", "chip_smoke_long")
RUN_DIR_DISSIPATION = os.path.join(HERE, "runs", "chip_smoke_dissipation")
# K1, K2, the loop's device stamps (``utils/profiling.py``) and the conditional
# node of the world step's auto-reset (``utils/graphs.py``).
KERNEL_SOURCES = ("ks_control_period.cu", "ks_control_period_limb.cu", "device_stamp.cu",
                  "graph_conditional.cu")
LIMB_MODES = ("bf16", "bf16_3x", "bf16_4x")
# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet,
# dense): float32 outside the tensor cores, bf16 products with float32
# accumulation on the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# FLOPs per grid point and sub-step of a control period, by direct stencil,
# as (float32 FLOPs, bf16-product FLOPs).  Per RHS evaluation: 21 taps as
# FMAs (u_xx 7, u_xxxx 9, and the one 5-tap upwind sum that the sign of the
# stage value picks; 2 FLOPs each), 8 for the square, the combine and the
# stage input, and in K2 7 more for the bf16 limbs of the stage value and
# its square; per sub-step 4 RHS evaluations plus 10 for the RK4 combine
# and the reward.  K1's taps are float32 products; K2's are bf16 x bf16
# products accumulated in float32, one set per limb pass.
K1_FLOPS = (4 * (2 * 21 + 8) + 10, 0)
K2_FLOPS = {passes: (4 * (8 + 7) + 10, 4 * 2 * 21 * passes) for passes in (1, 3, 4)}
# K2 against its plain version.  The two sum the stencil products in other
# orders, so the bf16 rounding of an operand can flip on a last-bit
# difference.  In the limb modes the lo limb absorbs a flip; in one-pass
# bf16 a flip moves u by ~1e-3, and on an H100 its error grows from <1e-6
# at 25 sub-steps to ~2e-3 at 75 and ~9e-3 at 250.  So bf16 is held over
# periods of at most 25 sub-steps, each from the state both sides start at,
# and on fixed fields: on another smooth field at batch 64 one operand
# flipped within 20 sub-steps, and u moved by 5.8e-3.
K2_TOL = (1e-4, 1e-4)
# The kernels' general path (every grid of 9 to 1,024 points other than 32,
# 64, ..., 256, which the register path takes), held against the plain
# versions in phases 2 (K1) and 4 (K2) at these grids and batches, and
# timed at the grids of phase 22.  8 and 1,025 points lie outside the range
# and must raise before a launch.  Each grid n has L = 22 n / 64, the
# flagship's spacing.
K1_GRIDS = (9, 16, 48, 100, 320, 512, 1000, 1024)
K2_GRIDS = (16, 48, 320, 512)
GRID_BATCHES = (1, 12, 64)
GRID_TIMED = (48, 512)
OUTSIDE_GRIDS = (8, 1025)

# runscripts/mbpo_ks.sh with --solver pallas.  Cut from the flagship:
# total_timesteps 50000 -> 5060 (6 iterations after the 5000-step warmup),
# surrogate_train_freq 500 -> 30 (retrains at iterations 0 and 3), the
# trainer's max_steps 2000/250 -> 20/10, and checkpoint_freq 200 -> 2
# (snapshots after iterations 1, 3 and 5: steps 2, 4 and 6).  With
# agent_eval_freq 50, iteration 0 runs the one policy and surrogate
# evaluation of the run, and with logging_freq at its default of 10 it
# writes their artifacts and the retrain's plots.
MAIN_ARGS = [
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
    "--total_timesteps", "5060",
    "--rollout_length_schedule", json.dumps({
        "scheduler": "LinearScheduler", "steptype": "iteration",
        "start": 0, "stop": 200, "vmin": 3, "vmax": 7}),
    "--policy_train_steps_per_sample", "10",
    "--surrogate_train_freq", "30",
    "--checkpoint_freq", "2",
    "--solver", "pallas",
    "--run_dir", RUN_DIR,
]
# K1 launches of the main path: the reset pool (800 + 3 x 40 periods), the
# random warmup (5000 steps of 10 envs), the initial evaluation and
# iteration 0's (400-step episodes), and one collect step per iteration.
MAIN_K1_LAUNCHES = 920 + 500 + 400 + 400 + 6



def with_args(args, **changes):
    """``args`` with the value of each ``--flag`` in ``changes`` replaced."""
    out = list(args)
    for flag, value in changes.items():
        out[out.index("--" + flag) + 1] = value
    return out


# Phase 20: the main path on the dissipation channel.
DISSIPATION_ARGS = with_args(MAIN_ARGS, run_dir=RUN_DIR_DISSIPATION) + [
    "--env_config", json.dumps({"objective": ""})]


# Phase 22: the main path on two other grids, cut as phase 3 cuts it:
# 48 points on the flagship's domain (K1's general path), and 512 points on
# eight times the domain at the flagship's spacing through K2 at bf16_3x
# (K2's general path; the reset transient through K1's).  Each beside the
# launch counts predicted before its first run: the grid does not change
# how often a path steps its envs, so K1 launches as on the main path at 48
# points, and at 512 K1 runs the reset pool (920) and K2 the warmup, the
# two evaluations and the collect steps (500 + 400 + 400 + 6).
GRID_RUNS = (
    ("n=48, K1", with_args(MAIN_ARGS, run_dir=os.path.join(HERE, "runs", "chip_smoke_n48"))
     + ["--env_config", json.dumps({"n": 48})], {"K1": MAIN_K1_LAUNCHES, "K2": 0}),
    ("n=512, K2 bf16_3x",
     with_args(MAIN_ARGS, solver="pallas_packed",
               run_dir=os.path.join(HERE, "runs", "chip_smoke_n512"))
     + ["--env_config", json.dumps({"n": 512, "length": 176.0,
                                    "pallas_precision": "bf16_3x"})],
     {"K1": 920, "K2": 500 + 400 + 400 + 6}),
)

# Phase 21: the twin on the card (tests/twin_tape.py).
RUN_DIR_TWIN = os.path.join(HERE, "runs", "chip_smoke_twin")
TWIN_HOST_TIMEOUT = 600
# Phase 23: the latent and Burgers twins.  K1 launches once per batched env
# step: the latent tape's 5-step warmup, its evaluation (8 steps), 10
# iterations and the evaluations at 0, 4 and 8 (8 steps each), one more
# than phase 21's flagship tape (a 4-step warmup).  The Burgers tape must
# launch neither kernel.
TWIN_K1_LAUNCHES = {"latent": 47}


# Phase 13: the main path with the phases one after another (each a graph),
# and in a controller built with graphs=False.
EAGER_ARGS = with_args(MAIN_ARGS, run_dir=RUN_DIR_EAGER) + ["--no_fuse_iteration"]
NO_GRAPHS_ARGS = with_args(EAGER_ARGS, run_dir=RUN_DIR_NO_GRAPHS)
# Fields of a record that read the host's clock or its garbage collector
# (and every t_* timer), or the graph pool's size.
CLOCK_FIELDS = ("start", "time", "_time", "env_steps_per_sec", "gc_max_pause", "n_gc2",
                "graph_pool_mb", "fit_graph_pool_mb")

# Phase 8: the same command with --resume and 20 more env steps.
RESUME_ARGS = with_args(MAIN_ARGS, total_timesteps="5080") + ["--resume"]

# Phase 9: iterations 0 and 1 of the main path, the trainer cut to 5 steps a
# fit, with a trace of iteration 1 (a non-retrain iteration).
TRACE_ARGS = with_args(
    MAIN_ARGS, total_timesteps="5020", run_dir=RUN_DIR_TRACE,
    trainer=json.dumps({"initial": {"min_steps": 250, "max_steps": 5},
                        "iterations": {"min_steps": 50, "max_steps": 5}}),
) + ["--profile_dir", os.path.join(RUN_DIR_TRACE, "profile")]

# Phase 14: the flagship's "iterations" trainer config (patience 5 from
# MAIN_ARGS' --training, min_steps 50) with max_steps 250 -> 50, one retrain
# from phase 3's last snapshot under each fit route.
FIT_ARGS = with_args(
    MAIN_ARGS, run_dir=RUN_DIR_FIT, checkpoint_freq="0",
    trainer=json.dumps({"initial": {"min_steps": 250, "max_steps": 50},
                        "iterations": {"min_steps": 50, "max_steps": 50}}),
)
FIT_ROUTES = {"--sequential_member_training": ["--sequential_member_training"],
              "--sequential_member_training --no_fuse_fit": ["--sequential_member_training",
                                                              "--no_fuse_fit"],
              "--no_fuse_fit": ["--no_fuse_fit"], "default": []}
SNAPSHOT_STEP = 6
# The fields of a retrain record on the default fit route.
FIT_FIELDS = {"t_fit_prep", "t_fit_dispatch", "t_fit_ready", "t_fit_total", "steps", "epochs",
              "curriculum_K", "lr", "train_loss", "val_loss", "elite_scores"}

# Phase 17, runscripts/mbpo_ks_mesh.sh at DATA_PARALLEL=2 MODEL_PARALLEL=2:
# its batches (20 envs, 6 members and elites, rollout batch 200, policy batch
# 512) with MAIN_ARGS' cuts at its 20 envs: total_timesteps 5120 (6
# iterations of 20 steps after the 5000-step warmup) and surrogate_train_freq
# 60 (retrains at iterations 0 and 3).
MESH_RANKS = 4
MESH_ARGS = with_args(MAIN_ARGS, total_timesteps="5120", surrogate_train_freq="60") + [
    "--data_parallel", "2", "--model_parallel", "2", "--num_envs", "20",
    "--num_dynamics_models", "6", "--num_elite_models", "6",
    "--model_rollouts_batch_size", "200", "--policy_batch_size", "512",
]
MESH_ONE_ARGS = with_args(MESH_ARGS, data_parallel="1", model_parallel="1",
                          run_dir=RUN_DIR_MESH_ONE)
# K1 on the mesh path, on every rank and at 1x1: the reset pool (920 launches
# of 64 chains), two evaluations of 10 episodes (800 launches of 10 rows), and
# the collect launches, 250 of the warmup and one per iteration.
MESH_COLLECT_LAUNCHES = 250 + 6
MESH_K1_LAUNCHES = 920 + 800 + MESH_COLLECT_LAUNCHES
MESH_OTHER_ROWS = 920 * 64 + 800 * 10
# The comparison with 1x1 (``hold_one``: tests/test_parallel.py's keys up to
# iteration 0's SAC updates at rtol 2e-4 / atol 1e-7, the SAC keys printed
# beside ``sac_reorder_gaps``) is ``pdecontrol_tpu_torch/parallel/mesh_smoke.py``'s,
# which holds the same arguments on four cards through NCCL.

# Phase 19, what only a long run reaches: MAIN_ARGS for 10 iterations
# (total_timesteps 5100) with retrains at iterations 0 and 5
# (surrogate_train_freq 50) and these changes.  The horizon climbs from 3 to
# 7 over iterations 0-8, two iterations a horizon (3, 3, 4, 4, ..., 7, 7):
# the fused graph of a horizon is captured at its first non-retrain
# iteration and replayed there, and under --no_fuse_iteration the first
# iteration of a horizon captures its ("world", horizon, rounds) graph and
# the second replays it.  The world replay keeps 2 iterations' rollouts
# (model_buffer_store_iterations 30 -> 2: 2,000 rows of the 1,000 an
# iteration adds), so it wraps in iteration 2 and every later iteration
# writes and draws from a wrapped ring inside its graphs.  The trainer
# stops on patience 2 / 1 after min_steps 6 / 3, below max_steps 24, so
# that members stop at different epochs (the flagship: patience 10 / 5,
# min_steps 250 / 50, max_steps 2000 / 250).  No snapshots and no
# artifacts.
LONG_ITERATIONS = 10
LONG_HORIZONS = (3, 4, 5, 6, 7)
LONG_SCHEDULE = {"scheduler": "LinearScheduler", "steptype": "iteration",
                 "start": 0, "stop": 8, "vmin": 3, "vmax": 7}
LONG_ARGS = with_args(
    MAIN_ARGS, run_dir=RUN_DIR_LONG, total_timesteps=str(5000 + 10 * LONG_ITERATIONS),
    surrogate_train_freq="50", checkpoint_freq="0",
    rollout_length_schedule=json.dumps(LONG_SCHEDULE),
    training=json.dumps({
        "tau": 5,
        "initial": {"tbtt": 10, "patience": 2, "batch_size": 64},
        "iterations": {"tbtt": 10, "patience": 1, "batch_size": 64}}),
    trainer=json.dumps({"initial": {"min_steps": 6, "max_steps": 24},
                        "iterations": {"min_steps": 3, "max_steps": 24}}),
) + ["--model_buffer_store_iterations", "2", "--logging_freq", "0"]
# The three routes, as phase 13's; the second also fits eagerly
# (--no_fuse_fit), so that its fits hold the default route's graphed fits.
LONG_ROUTES = {"default": ([], True),
               "--no_fuse_iteration --no_fuse_fit": (["--no_fuse_iteration",
                                                      "--no_fuse_fit"], True),
               "graphs=False": (["--no_fuse_iteration"], False)}
# K1 on each route: the main path's but for one collect launch an iteration.
LONG_K1_LAUNCHES = 920 + 500 + 400 + 400 + LONG_ITERATIONS

# runscripts/mbpo_ks_bf16.sh: the same run through K2 at bf16_3x, with
# agent_eval_freq 50 -> 5, so that iteration 5 evaluates on the fused route
# (its record carries t_fused).
BF16_ARGS = MAIN_ARGS[: MAIN_ARGS.index("--solver")] + [
    "--solver", "pallas_packed",
    "--env_config", json.dumps({"pallas_precision": "bf16_3x"}),
    "--run_dir", RUN_DIR_BF16, "--agent_eval_freq", "5",
]
BF16_EVALS = (0, 5)

# The SAC baseline's defaults (SAC hidden 256, batch 256, 10 envs, one
# update per env step, a log record every 100 steps of the 10 envs) through
# K2, cut to 5,000 env steps after a 2,000-step random warmup; evaluations
# (10 episodes of 400 steps) at 3,000 and 4,000 steps.
SAC_ARGS = [
    "--env_config", json.dumps({"solver": "pallas_packed", "pallas_precision": "bf16_3x"}),
    "--total_timesteps", "5000",
    "--learning_starts", "2000",
    "--run_dir", RUN_DIR_SAC,
]

# Phase 10, runscripts/mbpo_ks_latent_r4.sh: the flagship run with the latent
# conv-LSTM family, patience 10 in both trainer phases and the larger
# per-retrain budget (max_steps 2000 / 750), which MAIN_ARGS' cut brings to
# 20 / 10 as on the main path.
LATENT_ARGS = with_args(
    MAIN_ARGS, factory="KSLatentConvolutionalLSTM", run_dir=RUN_DIR_LATENT,
    training=json.dumps({
        "tau": 5,
        "initial": {"tbtt": 10, "patience": 10, "batch_size": 64},
        "iterations": {"tbtt": 10, "patience": 10, "batch_size": 64}}),
)

# Phase 11, runscripts/mbpo_burgers.sh (its --training, --trainer, --curriculum
# and schedules are the flagship's) with MAIN_ARGS' cuts and no --solver: the
# Burgers env has one solver, an eager loop of about 24 small launches per
# Heun sub-step.  Cut further, so that the phase takes about a minute:
# learning_starts 5000 -> 1000 (100 random steps of the 10 envs) with
# total_timesteps 1060 (6 iterations), and t_max 100 -> 25 in --env_config
# (100-step episodes, so that the warmup still completes one episode per env
# and an evaluation takes 100 env steps, not 400).
BURGERS_ARGS = with_args(
    MAIN_ARGS[: MAIN_ARGS.index("--solver")] + ["--run_dir", RUN_DIR_BURGERS],
    env_id="BurgersEnv-v0", learning_starts="1000", total_timesteps="1060",
) + ["--reward_scale", "500", "--env_config", json.dumps({"t_max": 25.0})]
# Env steps of the Burgers path at batch 10: the warmup, the initial
# evaluation and iteration 0's, and one collect step per iteration.
BURGERS_WARMUP_STEPS = 100
BURGERS_ENV_STEPS = BURGERS_WARMUP_STEPS + 100 + 100 + 6

# Phase 12, runscripts/offline.sh's dataset and runscripts/capacity.sh's
# sweep, cut to one of the 5 folds and max_epochs 150 -> 2 (10 TBPTT steps
# of batch 64 on windows of 10 + 30 steps, 2 validation batches and the
# battery on the held-out fold's 370 windows).
OFFLINE_DATA = os.path.join(RUN_DIR_OFFLINE, "ks_attractor.npz")
OFFLINE_EPISODES, OFFLINE_EPISODE_STEPS, OFFLINE_WINDOW = 100, 400, 10 + 30
FACTORIES = ("KSAutoRegConvolutionalLSTM", "KSAutoRegFullyConnectedLSTM",
             "KSLatentConvolutionalLSTM", "KSLatentLSTM", "KSDelayCNNSurrogateFactory")
GENERATE_ARGS = ["--env", "KuramotoSivashinskyEnv-v0", "--episodes", str(OFFLINE_EPISODES),
                 "--config", json.dumps({"solver": "pallas"}), "--output", OFFLINE_DATA]
# K1 launches of generate: the reset pool of 100 states (64 chains through
# 800 + 40 periods) and one 400-step episode of the 100 envs.
GENERATE_K1_LAUNCHES = 840 + 400


def evaluate_args(factory):
    return ["--env_id", "KuramotoSivashinskyEnv-v0", "--data", OFFLINE_DATA,
            "--splits", "5", "--total", "0.5", "--target_length", "30",
            "--factory", factory,
            "--training", json.dumps({"tbtt": 1000000, "tau": 10, "batch_size": 64,
                                      "patience": 50}),
            "--trainer", json.dumps({"max_epochs": 2, "gradient_clip_val": 0.5}),
            "--max_folds", "1",
            "--output", os.path.join(RUN_DIR_OFFLINE, f"capacity_{factory}")]


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name: str, t0: float) -> None:
    print(f"== {name}: ok in {time.perf_counter() - t0:.2f} s", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_period(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` (CUDA events, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def period_bound(b, n, cfg_steps, flops_per_point_step):
    """``(bound_ms, bound_by)`` of one control period of a ``[b, n]`` batch:
    the larger of its operations (``(fp32, bf16)`` FLOPs per point and
    sub-step, each type over its own peak, the two times added) and its
    bytes (u and phi read once, u and the reward written once) over the
    memory rate."""
    fp32, bf16 = flops_per_point_step
    t_ops = b * n * cfg_steps * (fp32 / PEAK_FP32_FLOPS + bf16 / PEAK_BF16_FLOPS)
    t_bytes = 4 * (3 * b * n + b) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_report(source):
    """One line per kernel of ``source``: registers and spill bytes, as
    ``nvcc -Xptxas -v`` reported them when the library was built."""
    import re

    from pdecontrol_tpu_torch.ops import cuda_build

    lines, entry, spill = [], None, ""
    for line in cuda_build.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            lines.append(f"{entry}: {m.group(1)} registers, {spill}")
            entry, spill = None, ""
    return lines


def holds(kernel, label, got, ref, rtol, atol, errors):
    """Hold one kernel output to its reference; record the max abs error."""
    import torch

    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    errors.append(err)
    ok = bool(torch.allclose(got, ref, rtol=rtol, atol=atol))
    print(f"   {label}: max abs err {err:.3e} (rtol {rtol}, atol {atol}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{kernel} disagrees with the plain version: {label}")


def build_kernels() -> None:
    """Phase 1: one nvcc for each kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from pdecontrol_tpu_torch.ops import cuda_build, pallas_ks, pallas_ks_packed

    def one(source):
        t = time.perf_counter()
        cuda_build.build(source)
        return source, time.perf_counter() - t

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for source, seconds in pool.map(one, KERNEL_SOURCES):
            print(f"   {source}: build seconds {seconds:.2f}", flush=True)
            for line in ptxas_report(source):
                print(f"     ptxas {line}", flush=True)
    pallas_ks.build()
    pallas_ks_packed.build()


def check_kernel(errors):
    """Phase 2: K1 against the plain version; returns K1's timings."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.envs.kuramoto import (EnvState, KuramotoSivashinsky,
                                                    make_reset_pool)
    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def operators(n):
        # The flagship's grid spacing (L = 22 at 64 points) at every n, so
        # that dt = 1e-3 stays inside RK4's stability region.
        return KSOperators.create(n, 22.0 * n / 64, dtype=torch.float32, device=dev)

    ops = operators(64)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def compare(label, got, ref, rtol, atol):
        holds("K1", label, got, ref, rtol, atol, errors)

    for objective in ("l2control", "dissipation"):
        for n in (32, 64, 128):
            ops_n = operators(n)
            wave = 0.3 * np.sin(2 * np.pi * np.arange(n) / n)[None]
            for b in (12, 8, 64):
                u = tensor(rng.uniform(-1, 1, (b, n)))
                phi = tensor(np.repeat(wave, b, 0))
                got = pallas_ks.ks_control_period(ops_n, u, phi, 1e-3, 20, objective)
                ref = pallas_ks.ks_control_period_plain(ops_n, u, phi, 1e-3, 20, objective)
                for name, g, r in zip(("u", "reward"), got, ref):
                    compare(f"{objective} n={n} B={b} 20 sub-steps {name}", g, r, 2e-5, 2e-6)

        env_k = KuramotoSivashinsky.create(cfg_steps=25, objective=objective,
                                           legacy_objective=False, solver="pallas",
                                           device=dev)
        env_p = KuramotoSivashinsky.create(cfg_steps=25, objective=objective,
                                           legacy_objective=False, solver="xla",
                                           device=dev)
        for shape in ((8,), ()):
            u0 = tensor(rng.uniform(-1, 1, shape + (64,)))
            sk = sp = EnvState(u=u0, step=torch.zeros(shape, dtype=torch.int32, device=dev))
            for t in range(3):
                a = tensor(rng.uniform(-1, 1, shape + (1, 4)))
                sk, ok_ = env_k.step(sk, a)
                sp, op_ = env_p.step(sp, a)
                label = f"{objective} env.step {list(shape) or 'unbatched'} period {t}"
                compare(label + " obs", ok_.obs, op_.obs, 3e-5, 3e-6)
                compare(label + " reward", ok_.reward, op_.reward, 3e-5, 3e-6)

        # B=100 is the offline dataset's batch (phase 12), the others the MBPO paths'.
        for b in (10, 64, 100, 1024):
            u = tensor(rng.uniform(-1, 1, (b, 64)))
            phi = tensor(rng.uniform(-0.5, 0.5, (b, 64)))
            got = pallas_ks.ks_control_period(ops, u, phi, 1e-3, 250, objective)
            ref = pallas_ks.ks_control_period_plain(ops, u, phi, 1e-3, 250, objective)
            for name, g, r in zip(("u", "reward"), got, ref):
                compare(f"{objective} B={b} 250 sub-steps {name}", g, r, 1e-4, 1e-5)

    # The reset pool of every path: 64 chains through 800 + 3 x 40 periods.
    env = KuramotoSivashinsky.create(solver="pallas", device=dev)
    before = pallas_ks.launch_count
    torch.cuda.synchronize()
    t = time.perf_counter()
    make_reset_pool(env, torch.Generator(device=dev).manual_seed(0), 256)
    torch.cuda.synchronize()
    print(f"   reset pool (256 states, {pallas_ks.launch_count - before} K1 launches at "
          f"B=64): {time.perf_counter() - t:.4f} s", flush=True)

    def fields(b, n):
        return tensor(rng.uniform(-1, 1, (b, n))), tensor(rng.uniform(-0.5, 0.5, (b, n)))

    timings = time_periods(
        "K1", lambda ops, u, phi: pallas_ks.ks_control_period(ops, u, phi, 1e-3, 250),
        lambda ops, u, phi: pallas_ks.ks_control_period_plain(ops, u, phi, 1e-3, 250),
        [(64, b) for b in (10, 64, 100, 1024)], fields, K1_FLOPS)
    return {b: t for (_, b), t in timings.items()}


def smooth_fields(rng, b, scale, n=64, modes=8):
    """``b`` smooth periodic rows of ``n`` points (the lowest ``modes``
    wavenumbers, as on the KS attractor), max |u| = ``scale``."""
    import numpy as np

    f = np.fft.rfft(rng.normal(size=(b, n)), axis=-1)
    f[:, modes:] = 0
    u = np.fft.irfft(f, n=n, axis=-1)
    return (u / np.abs(u).max() * scale).astype(np.float32)


def limb_period_fns(precision):
    """K2 and its plain version over one l2control period at ``precision``,
    as ``time_periods`` takes them."""
    from pdecontrol_tpu_torch.ops import pallas_ks_packed as K

    def kernel(ops, u, phi):
        return K.ks_control_period_packed(ops, u, phi, 1e-3, 250, "l2control", precision)

    def plain(ops, u, phi):
        return K.ks_control_period_packed_plain(ops, u, phi, 1e-3, 250, "l2control",
                                                precision)

    return kernel, plain


def check_limb_kernel(errors, k1_errors):
    """Phase 4: K2 against its plain version, on smooth fields with
    |u| <= 3 (the attractor's range) at the flagship spacing (L = 22 n/64),
    at rtol/atol ``K2_TOL``:

      * 20 sub-steps at batch 1, 12, 8 and 64 on 64 points and at batch 8
        on 32 and 128 points, every limb mode, both objectives, and for
        ``bf16_3x`` and ``bf16_4x`` also at batch 8 on 96 and 256 points
        (1 to 8 points per lane: every halo case);
      * 3 control periods x 25 sub-steps through ``env.step`` at batch 8
        (K2; each period held from the state both sides start it from), at
        batch 7 and for one unbatched state (odd flat batches go to K1 in
        float32: no K2 launch, held to K1's plain version at 3e-5 / 3e-6,
        and counted with K1's errors);
      * one 250-sub-step period at batch 10, 64 and 1024 for ``bf16_3x``
        and ``bf16_4x`` (one-pass ``bf16`` is held at 20 sub-steps only:
        its rounding flips add up over a full period).

    Returns K2's and the plain version's time per period, keyed by
    ``(precision, batch)``."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.envs.kuramoto import EnvState, KuramotoSivashinsky
    from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed as K
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    dev = torch.device("cuda")

    def operators(n):
        return KSOperators.create(n, 22.0 * n / 64, dtype=torch.float32, device=dev)

    ops = operators(64)
    rng = np.random.default_rng(1)
    # The grids of 96 and 256 points draw from a generator of their own, so
    # that the other cases keep the fields they have been held on: one-pass
    # bf16 is held only on fields where no rounding flips (see K2_TOL), and
    # drawn in another order, one field at batch 64 flipped.
    rng_wide = np.random.default_rng(2)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def fields(b, n=64, gen=rng):
        return tensor(smooth_fields(gen, b, 3.0, n)), tensor(smooth_fields(gen, b, 0.5, n))

    def compare(label, got, ref, kernel="K2", tol=K2_TOL):
        holds(kernel, label, got, ref, tol[0], tol[1], errors if kernel == "K2" else k1_errors)

    for precision in LIMB_MODES:
        for objective in ("l2control", "dissipation"):
            tag = f"{precision} {objective}"
            cases = ((64, 1), (64, 12), (64, 8), (64, 64), (32, 8), (128, 8))
            if precision != "bf16":
                # One-pass bf16 flipped an operand on this generator's field
                # at n = 256 (7.9e-4 after 20 sub-steps); it is held at
                # n = 96 and 256 by tests/test_torch_cuda.py.
                cases += ((96, 8), (256, 8))
            for n, b in cases:
                ops_n = operators(n)
                u, phi = fields(b, n, rng_wide if n in (96, 256) else rng)
                got = K.ks_control_period_packed(ops_n, u, phi, 1e-3, 20, objective, precision)
                ref = K.ks_control_period_packed_plain(ops_n, u, phi, 1e-3, 20, objective,
                                                       precision)
                for name, g, r in zip(("u", "reward"), got, ref):
                    compare(f"{tag} n={n} B={b} 20 sub-steps {name}", g, r)

            env = KuramotoSivashinsky.create(cfg_steps=25, objective=objective,
                                             legacy_objective=False, solver="pallas_packed",
                                             pallas_precision=precision, device=dev)
            for shape in ((8,), (7,), ()):
                flat = int(np.prod(shape))
                state = EnvState(u=tensor(smooth_fields(rng, flat, 3.0).reshape(shape + (64,))),
                                 step=torch.zeros(shape, dtype=torch.int32, device=dev))
                before = K.launch_count
                for t in range(3):
                    a = tensor(rng.uniform(-1, 1, shape + (1, 4)))
                    u_in = state.u.reshape(-1, 64)
                    phi = env.action_to_phi(a).reshape(-1, 64)
                    state, out = env.step(state, a)
                    label = f"{tag} env.step {list(shape) or 'unbatched'} period {t}"
                    if flat % 2 == 0:
                        ref = K.ks_control_period_packed_plain(ops, u_in, phi, 1e-3, 25,
                                                               objective, precision)
                        kernel, tol = "K2", K2_TOL
                    else:
                        ref = pallas_ks.ks_control_period_plain(ops, u_in, phi, 1e-3, 25,
                                                                objective)
                        kernel, tol = "K1", (3e-5, 3e-6)
                    compare(label + " obs", out.obs.reshape(-1, 64), ref[0], kernel, tol)
                    compare(label + " reward", out.reward.reshape(-1), ref[1], kernel, tol)
                torch.cuda.synchronize()
                launched = K.launch_count - before
                want = 3 if flat % 2 == 0 else 0
                print(f"   {tag} env.step {list(shape) or 'unbatched'}: {launched} K2 launches",
                      flush=True)
                if launched != want:
                    raise AssertionError(f"{launched} K2 launches for batch shape {shape}, "
                                         f"expected {want}")

            if precision == "bf16":
                continue
            for b in (10, 64, 1024):
                u, phi = fields(b)
                got = K.ks_control_period_packed(ops, u, phi, 1e-3, 250, objective, precision)
                ref = K.ks_control_period_packed_plain(ops, u, phi, 1e-3, 250, objective,
                                                       precision)
                for name, g, r in zip(("u", "reward"), got, ref):
                    compare(f"{tag} B={b} 250 sub-steps {name}", g, r)

    timings = {}
    for precision, batches in (("bf16_3x", (10, 64, 1024)), ("bf16_4x", (10,))):
        timed = time_periods(f"{precision} K2", *limb_period_fns(precision),
                             [(64, b) for b in batches], fields,
                             K2_FLOPS[K.LIMB_PASSES[precision]])
        timings.update({(precision, b): t for (_, b), t in timed.items()})
    return timings


def grid_operators(n, device="cuda"):
    """The operators of an n-point grid at the flagship's spacing."""
    import torch

    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    return KSOperators.create(n, 22.0 * n / 64, dtype=torch.float32,
                              device=torch.device(device))


def refuse_outside(kernel, fn, counter):
    """Grids outside [9, 1024] must raise ValueError before a launch:
    ``fn(ops, u)`` calls the wrapper, ``counter()`` reads its launch count."""
    import torch

    for n in OUTSIDE_GRIDS:
        u = torch.zeros(2, n, device="cuda")
        before = counter()
        try:
            fn(grid_operators(n), u)
        except ValueError as e:
            print(f"   {kernel} at n={n}: ValueError ({e}) before a launch", flush=True)
        else:
            raise AssertionError(f"{kernel} took a grid of {n} points")
        if counter() != before:
            raise AssertionError(f"{kernel} launched on a grid of {n} points")


def time_periods(label, kernel, plain, cases, fields, flops):
    """A kernel's time per 250-sub-step period for each ``(n, batch)`` of
    ``cases`` (CUDA events; plain, kernel, kernel, plain: the two versions
    alternate), beside the plain version's and the roofline bound; keyed by
    ``(n, batch)``.  ``kernel`` and ``plain`` take ``(ops, u, phi)``,
    ``fields(b, n)`` draws the inputs."""
    timings = {}
    for n, b in cases:
        ops = grid_operators(n)
        u, phi = fields(b, n)
        p1 = time_period(lambda: plain(ops, u, phi), 3)
        k1 = time_period(lambda: kernel(ops, u, phi), 50)
        k2 = time_period(lambda: kernel(ops, u, phi), 50)
        p2 = time_period(lambda: plain(ops, u, phi), 3)
        bound, bound_by = period_bound(b, n, 250, flops)
        ms = min(k1, k2)
        timings[n, b] = {"ms": ms, "plain_ms": min(p1, p2), "bound_ms": bound,
                         "bound_by": bound_by}
        print(f"   per {label} control period (250 sub-steps) at n={n} B={b}: "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; bound "
              f"{bound:.6f} ms ({bound_by}), {100 * bound / ms:.2f}% of it", flush=True)
    return timings


def check_kernel_grids(errors):
    """Phase 2, the general path: K1 against its plain version on the
    host's CPU (a last-bit difference of another summation order can cross
    the upwind switch, see ``tests/test_torch_cuda.py``), 20 sub-steps at
    ``K1_GRIDS`` x ``GRID_BATCHES``, both objectives (rtol 2e-5, atol
    2e-6); 3 periods x 25 sub-steps of ``env.step`` at 48 points, batch 8
    and unbatched, against the plain solver's env on the CPU (rtol 3e-5,
    atol 3e-6); grids outside the range raise.  Its inputs come from a
    generator of their own, so that phase 2's other cases draw what they
    drew.  Returns the general path's timings."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.envs.kuramoto import EnvState, KuramotoSivashinsky
    from pdecontrol_tpu_torch.ops import pallas_ks

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    for objective in ("l2control", "dissipation"):
        for n in K1_GRIDS:
            ops_n = grid_operators(n)
            ops_cpu = grid_operators(n, "cpu")
            for b in GRID_BATCHES:
                u = tensor(rng.uniform(-1, 1, (b, n)))
                phi = tensor(rng.uniform(-0.5, 0.5, (b, n)))
                got = pallas_ks.ks_control_period(ops_n, u, phi, 1e-3, 20, objective)
                ref = pallas_ks.ks_control_period_plain(ops_cpu, u.cpu(), phi.cpu(), 1e-3, 20,
                                                        objective)
                for name, g, r in zip(("u", "reward"), got, ref):
                    holds("K1", f"{objective} n={n} B={b} 20 sub-steps {name}", g.cpu(), r,
                          2e-5, 2e-6, errors)

        kw = dict(n=48, length=16.5, cfg_steps=25, objective=objective, legacy_objective=False)
        env_k = KuramotoSivashinsky.create(solver="pallas", device=dev, **kw)
        env_p = KuramotoSivashinsky.create(solver="xla", device=torch.device("cpu"), **kw)
        for shape in ((8,), ()):
            u0 = rng.uniform(-1, 1, shape + (48,)).astype(np.float32)
            steps = np.zeros(shape, np.int32)
            sk = EnvState(u=tensor(u0), step=torch.as_tensor(steps, device=dev))
            sp = EnvState(u=torch.as_tensor(u0), step=torch.as_tensor(steps))
            for t in range(3):
                a = rng.uniform(-1, 1, shape + (1, 4)).astype(np.float32)
                sk, ok_ = env_k.step(sk, tensor(a))
                sp, op_ = env_p.step(sp, torch.as_tensor(a))
                label = f"{objective} env.step n=48 {list(shape) or 'unbatched'} period {t}"
                holds("K1", label + " obs", ok_.obs.cpu(), op_.obs, 3e-5, 3e-6, errors)
                holds("K1", label + " reward", ok_.reward.cpu(), op_.reward, 3e-5, 3e-6,
                      errors)

    refuse_outside("K1", lambda ops, u: pallas_ks.ks_control_period(ops, u, u, 1e-3, 2),
                   lambda: pallas_ks.launch_count)

    def fields(b, n):
        return (tensor(rng.uniform(-1, 1, (b, n))), tensor(rng.uniform(-0.5, 0.5, (b, n))))

    return time_periods(
        "K1", lambda ops, u, phi: pallas_ks.ks_control_period(ops, u, phi, 1e-3, 250),
        lambda ops, u, phi: pallas_ks.ks_control_period_plain(ops, u, phi, 1e-3, 250),
        [(n, b) for n in GRID_TIMED for b in (10, 1024)], fields, K1_FLOPS)


def check_limb_kernel_grids(errors, k1_errors):
    """Phase 4, the general path: K2 against its plain version on the card
    (``K2_TOL``), on smooth fields with |u| <= 3, 20 sub-steps at
    ``K2_GRIDS`` x ``GRID_BATCHES``, every limb mode, both objectives.
    One-pass bf16 is held at batch 1 only: the operand roundings that can
    flip between two summation orders grow with batch x grid (see
    ``K2_TOL``), and at batch 64 on 48 points one flipped within 20
    sub-steps (8.9e-4 on an H100); its gaps at 12 and 64 rows are printed.
    A row is one block of the same code at any batch, and bf16_3x and
    bf16_4x are held at every batch.  Then 3
    periods x 25 sub-steps of ``env.step`` at 48 points for batch 8 (K2),
    batch 7 and one unbatched state (odd flat batches go to K1's general
    path, held at 3e-5 / 3e-6 and counted with K1's errors); grids outside
    the range raise.  A generator of its own, as in phase 2.  Returns the
    general path's bf16_3x timings."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.envs.kuramoto import EnvState, KuramotoSivashinsky
    from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def fields(b, n):
        # The lowest n/8 wavenumbers: the flagship's band (8 at 64 points) in
        # physical units at L = 22 n / 64.  At 16 points the default 8 keeps
        # every wavenumber but the Nyquist, and on such a rough field
        # one-pass bf16 flipped an operand within 20 sub-steps (3.8e-4 at
        # batch 12 on an H100).
        modes = max(2, n // 8)
        return (tensor(smooth_fields(rng, b, 3.0, n, modes)),
                tensor(smooth_fields(rng, b, 0.5, n, modes)))

    ops48 = grid_operators(48)
    for precision in LIMB_MODES:
        for objective in ("l2control", "dissipation"):
            tag = f"{precision} {objective}"
            for n in K2_GRIDS:
                ops_n = grid_operators(n)
                for b in GRID_BATCHES:
                    u, phi = fields(b, n)
                    got = K.ks_control_period_packed(ops_n, u, phi, 1e-3, 20, objective,
                                                     precision)
                    ref = K.ks_control_period_packed_plain(ops_n, u, phi, 1e-3, 20, objective,
                                                           precision)
                    for name, g, r in zip(("u", "reward"), got, ref):
                        label = f"{tag} n={n} B={b} 20 sub-steps {name}"
                        if precision == "bf16" and b > 1:
                            torch.cuda.synchronize()
                            print(f"   {label}: max abs err {float((g - r).abs().max()):.3e} "
                                  f"(one-pass bf16 above batch 1: printed, not held)",
                                  flush=True)
                        else:
                            holds("K2", label, g, r, *K2_TOL, errors)

            env = KuramotoSivashinsky.create(n=48, length=16.5, cfg_steps=25,
                                             objective=objective, legacy_objective=False,
                                             solver="pallas_packed", pallas_precision=precision,
                                             device=dev)
            for shape in ((8,), (7,), ()):
                flat = int(np.prod(shape))
                u0 = smooth_fields(rng, flat, 3.0, 48, 6).reshape(shape + (48,))
                state = EnvState(u=tensor(u0),
                                 step=torch.zeros(shape, dtype=torch.int32, device=dev))
                before = K.launch_count
                for t in range(3):
                    a = tensor(rng.uniform(-1, 1, shape + (1, 4)))
                    u_in = state.u.reshape(-1, 48)
                    phi = env.action_to_phi(a).reshape(-1, 48)
                    state, out = env.step(state, a)
                    label = f"{tag} env.step n=48 {list(shape) or 'unbatched'} period {t}"
                    if flat % 2 == 0:
                        ref = K.ks_control_period_packed_plain(ops48, u_in, phi, 1e-3, 25,
                                                               objective, precision)
                        kernel, tol, errs = "K2", K2_TOL, errors
                    else:
                        ref = pallas_ks.ks_control_period_plain(ops48, u_in, phi, 1e-3, 25,
                                                                objective)
                        kernel, tol, errs = "K1", (3e-5, 3e-6), k1_errors
                    holds(kernel, label + " obs", out.obs.reshape(-1, 48), ref[0], *tol, errs)
                    holds(kernel, label + " reward", out.reward.reshape(-1), ref[1], *tol, errs)
                torch.cuda.synchronize()
                launched = K.launch_count - before
                want = 3 if flat % 2 == 0 else 0
                print(f"   {tag} env.step n=48 {list(shape) or 'unbatched'}: {launched} K2 "
                      f"launches", flush=True)
                if launched != want:
                    raise AssertionError(f"{launched} K2 launches for batch shape {shape} at "
                                         f"n=48, expected {want}")

    refuse_outside("K2", lambda ops, u: K.ks_control_period_packed(ops, u, u, 1e-3, 2,
                                                                   precision="bf16_3x"),
                   lambda: K.launch_count)
    return time_periods("bf16_3x K2", *limb_period_fns("bf16_3x"),
                        [(n, b) for n in GRID_TIMED for b in (10, 1024)], fields,
                        K2_FLOPS[K.LIMB_PASSES["bf16_3x"]])


def gate_routes():
    """Phase 5, first: the float32 side's rollout at 64 envs x (10 + 20)
    periods with each period replayed from its CUDA graph, against the same
    rollout eagerly; the statistics must be equal bitwise."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.envs.kuramoto import KuramotoSivashinsky
    from pdecontrol_tpu_torch.evaluation import bf16_gate

    dev = torch.device("cuda")
    env = KuramotoSivashinsky.create(solver="xla", device=dev)
    u0 = torch.rand((64, env.n), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev) * 2 - 1
    out, seconds = {}, {}
    for graphs in (True, False, True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[graphs] = bf16_gate.rollout_stats_from(env, u0, 10, 20, graphs=graphs)
        torch.cuda.synchronize()
        seconds.setdefault(graphs, []).append(time.perf_counter() - t)
    spectra = [out[g].pop("spectrum") for g in (True, False)]
    if out[True] != out[False] or not np.array_equal(*spectra):
        raise AssertionError(f"the gate's graphed rollout differs from the eager one: {out}")
    print(f"   float32 side, 64 envs x (10 + 20) periods: graphed {seconds[True][0]:.2f} s "
          f"(captures included) / {seconds[True][1]:.2f} s, eager {seconds[False][0]:.2f} s; "
          f"statistics equal bitwise", flush=True)


def run_gate():
    """Phase 5: the attractor gate at its full size."""
    import torch

    from pdecontrol_tpu_torch.envs.kuramoto import KuramotoSivashinsky
    from pdecontrol_tpu_torch.evaluation import bf16_gate
    from pdecontrol_tpu_torch.ops import pallas_ks_packed

    dev = torch.device("cuda")
    batch, transient, periods = 512, 100, 400

    def stats(env):
        t = time.perf_counter()
        s = bf16_gate.rollout_stats(env, torch.Generator(device=dev).manual_seed(0),
                                    batch, transient, periods)
        print(f"   {env.solver}/{env.pallas_precision}: {batch} envs x {transient} + "
              f"{periods} periods in {time.perf_counter() - t:.2f} s", flush=True)
        return s

    fp32 = stats(KuramotoSivashinsky.create(solver="xla", device=dev))
    verdicts = {}
    for precision in ("bf16_3x", "bf16_4x"):
        env = KuramotoSivashinsky.create(solver="pallas_packed", pallas_precision=precision,
                                         device=dev)
        before = pallas_ks_packed.launch_count
        verdict = bf16_gate.compare(fp32, stats(env), 0.02, 0.10)
        launched = pallas_ks_packed.launch_count - before
        if launched != transient + periods:
            raise AssertionError(f"{launched} K2 launches in the {precision} gate run")
        tpu = json.load(open(os.path.join(HERE, "results",
                                          f"bf16_fidelity_{precision[5:]}.json")))
        for k in ("mean_energy", "mean_ux2", "mean_uxx2"):
            v = verdict[k]
            print(f"   {precision} {k}: fp32 {v['fp32']:.6f} fast {v['fast']:.6f} "
                  f"rel_err {v['rel_err']:.3e} (tol {v['tol']}; TPU receipt "
                  f"{tpu[k]['rel_err']:.3e})", flush=True)
        s = verdict["spectrum"]
        print(f"   {precision} spectrum: {s['bins_compared']} bins, max rel_err "
              f"{s['max_rel_err']:.3e}, mean {s['mean_rel_err']:.3e} (tol {s['tol']}; TPU "
              f"receipt max {tpu['spectrum']['max_rel_err']:.3e}, mean "
              f"{tpu['spectrum']['mean_rel_err']:.3e})", flush=True)
        if not verdict["ok"]:
            raise AssertionError(f"the {precision} gate failed: {json.dumps(verdict)}")
        verdicts[precision] = verdict
    return verdicts


def counted_run(label, fn):
    """Run one path with both kernels' launch counts set to 0 just before
    it; return its result and the counts read just after it."""
    from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed

    pallas_ks.launch_count = 0
    pallas_ks_packed.launch_count = 0
    out = fn()
    counts = {"K1": pallas_ks.launch_count, "K2": pallas_ks_packed.launch_count}
    print(f"   {label}: kernel launches {json.dumps(counts)}", flush=True)
    return out, counts


def require(counts, kernels, label):
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"{label} never launched {k}")


def check_records(path, checked):
    if not os.path.exists(path):
        raise AssertionError(f"{path} was not written")
    records = [json.loads(line) for line in open(path)]
    seen = {k: [r[k] for r in records if k in r] for k in checked}
    for k, vals in seen.items():
        if not vals:
            raise AssertionError(f"no {k} was logged")
        if not all(isinstance(v, (int, float)) and math.isfinite(v) for v in vals):
            raise AssertionError(f"{k} not finite: {vals}")
    return records, seen


METRICS = ("train_loss", "val_loss", "sac_qf_loss", "sac_policy_loss", "eval_return_mean",
           "collect_reward_mean", "imagined_reward_mean", "world_return_mean",
           "surrogate_open_loop_mse")
# At 20 envs the 5000-step warmup is 250 steps of each 400-step episode, so
# iteration 0's surrogate evaluation finds no finished episode and logs no
# error, in one process as on the mesh.
MESH_METRICS = tuple(k for k in METRICS if k != "surrogate_open_loop_mse")
# Keys of the evaluation artifacts of the JAX package
# (``pdecontrol_tpu/mbrl/controller.py`` ``_save_eval_artifact`` and
# ``_save_surrogate_artifact``).
ARTIFACT_KEYS = {
    "eval_{}.npz": {"obs", "actions", "rewards"},
    "surrogate_eval_{}.npz": {"states", "outputs", "actions", "rewards", "rpred", "hstep_mse"},
}
# Keys of ``fold{k}_metrics.npz`` (``pdecontrol_tpu/train/metrics.py``), KS.
BATTERY_KEYS = (
    {"MSE", "states", "outputs", "actions"}
    | {f"{m}{s}" for m in ("l1_loss", "l2_loss", "l1_loss_scaled", "l2_loss_scaled", "nrmse")
       for s in ("", "_rews")}
    | {f"{m}-derivative-{d}" for m in ("l1_loss_derivs", "l2_loss_derivs",
                                       "l1_loss_scaled_derivs", "l2_loss_scaled_derivs",
                                       "nrms_derivs") for d in range(3)}
)
# The plots of the first retrain, and of each evaluation iteration.
PLOTS = {f"{stage}_{kind}_iter0.png" for stage in ("train", "val") for kind in ("vis", "spatial")}
EVAL_PLOTS = ("surrogate_iter{}.png", "hstep_iter{}.png")


def has_module(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def can_render() -> bool:
    """Whether this host has what ``viz/plots.py`` imports."""
    return has_module("matplotlib") and has_module("PIL")


def check_outputs(run_dir, steps, evals=(0,)):
    """The files a run leaves beside ``metrics.jsonl``: the snapshots
    ``steps``, the evaluation artifacts of the iterations ``evals`` with the
    JAX package's keys and finite contents, and, where the host can render,
    the plots."""
    import numpy as np

    names = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    if names != sorted(f"{s}.pt" for s in steps):
        raise AssertionError(f"checkpoints/ holds {names}, expected the steps {steps}")
    for name, keys in ((n.format(i), k) for i in evals for n, k in ARTIFACT_KEYS.items()):
        with np.load(os.path.join(run_dir, "evaluation", name)) as z:
            if set(z.files) != keys:
                raise AssertionError(f"{name} holds {sorted(z.files)}")
            shapes = {k: z[k].shape for k in z.files}
            if not all(np.isfinite(z[k]).all() for k in z.files):
                raise AssertionError(f"{name} holds non-finite values")
        print(f"   {name}: {shapes}", flush=True)
    plots_dir = os.path.join(run_dir, "plots")
    plots = set(os.listdir(plots_dir)) if os.path.isdir(plots_dir) else set()
    want = PLOTS | {p.format(i) for i in evals for p in EVAL_PLOTS}
    if can_render() and plots != want:
        raise AssertionError(f"plots/ holds {sorted(plots)}, expected {sorted(want)}")
    print(f"   checkpoints {names}; plots {sorted(plots)}", flush=True)


def check_route(records, fused, graphs=True, eager_fit=False):
    """Each iteration's fields say which route ran it: a retrain, or every
    iteration under ``--no_fuse_iteration``, times its phases one after
    another; any other iteration is dispatched as one body and pulled late
    (``t_ready``) or, on an evaluation iteration, at once (``t_fused``).
    With graphs, iteration 0 captures its phases' graphs (``t_capture``);
    without, nothing captures.  ``eager_fit``: the run's fit is
    ``--no_fuse_fit``'s."""
    for r in records:
        if not fused or "t_surrogate" in r:
            want, banned = {"t_collect", "t_imagine", "t_policy", "t_pull"}, "t_dispatch"
        else:
            want = {"t_dispatch", "t_fused" if "t_eval" in r else "t_ready"}
            banned = "t_collect"
        if not want <= set(r) or banned in r:
            raise AssertionError(f"iteration {r['iteration']} ran the wrong route: "
                                 f"{sorted(k for k in r if k.startswith('t_'))}")
    captured = [r["iteration"] for r in records if "t_capture" in r]
    if graphs and (0 not in captured or (fused and len(captured) < 2)):
        raise AssertionError(f"the graphs were captured at iterations {captured}")
    if not graphs and captured:
        raise AssertionError(f"the run without graphs captured at iterations {captured}")
    check_fit_route(records, graphs, eager_fit)


def check_fit_route(records, graphs=True, eager_fit=False):
    """Every retrain ran the default lock-step fit, its steps from graphs
    captured at the run's first retrain (or eagerly, without graphs), or
    with ``eager_fit`` the lock-step fit of ``--no_fuse_fit``, which
    captures nothing."""
    retrains = [r for r in records if "t_surrogate" in r]
    if eager_fit:
        want, banned = FIT_FIELDS - {"t_fit_ready"} | {"t_fit_val"}, "t_fit_ready"
        graphs = False
    else:
        want, banned = FIT_FIELDS, "t_fit_val"
    for r in retrains:
        if not want <= set(r) or banned in r:
            raise AssertionError(f"iteration {r['iteration']}'s retrain ran another fit "
                                 f"route: {sorted(k for k in r if k.startswith('t_fit'))}")
    if retrains and ("t_fit_capture" in retrains[0]) != graphs:
        raise AssertionError(f"the first retrain's fit captured {retrains[0].get('t_fit_capture')}"
                             f" (graphs {graphs})")


def run_mbpo(args, run_dir, kernels, fused=True, evals=(0,), graphs=True):
    """Phases 3, 6, 10, 11 and 13: the port's MBPO CLI entry point for 6
    iterations, or with ``graphs=False`` its controller built so."""
    from pdecontrol_tpu_torch.mbrl import script

    shutil.rmtree(run_dir, ignore_errors=True)
    if graphs:
        print("   args: " + " ".join(args), flush=True)
        rc, counts = counted_run("script.main", lambda: script.main(args))
    else:
        def learn():
            ctl = build_controller(args, graphs=False)
            try:
                ctl.learn()
            finally:
                ctl.logger.finish()
            return 0

        rc, counts = counted_run("learn() of a controller built with graphs=False", learn)
    if rc != 0:
        raise RuntimeError(f"learn() failed (script.main returned {rc})")
    require(counts, kernels, "the MBPO run")

    records, seen = check_records(os.path.join(run_dir, "metrics.jsonl"), METRICS)
    check_outputs(run_dir, (2, 4, 6), evals)
    iters = [r for r in records if "iteration" in r]
    retrains = sum(1 for r in records if "num_ensemble_updates" in r)
    if len(iters) != 6 or retrains < 2:
        raise AssertionError(f"{len(iters)} iterations, {retrains} retrains")
    check_route(iters, fused, graphs)
    for r in iters:
        t = {k: v for k, v in r.items() if k.startswith("t_") or k == "graph_pool_mb"}
        print(f"   iteration {r['iteration']}: {json.dumps(t)} "
              f"env_steps_per_sec {r['env_steps_per_sec']:.2f}", flush=True)
    first = records[0]
    print(f"   warmup: t_warmup_collect {first['t_warmup_collect']} s, "
          f"t_warmup_eval {first['t_warmup_eval']} s", flush=True)
    for k, vals in seen.items():
        print(f"   {k}: {vals}", flush=True)
    return counts


def run_dissipation():
    """Phase 20: the main path with ``{"objective": ""}``, through K1."""
    counts = run_mbpo(DISSIPATION_ARGS, RUN_DIR_DISSIPATION, ("K1",))
    if counts != {"K1": MAIN_K1_LAUNCHES, "K2": 0}:
        raise AssertionError(f"the dissipation path launched {counts}, expected K1 "
                             f"{MAIN_K1_LAUNCHES} times and K2 never")
    env_config = json.load(open(os.path.join(RUN_DIR_DISSIPATION, "config.json")))["env_config"]
    if env_config.get("objective") != "" or env_config.get("solver") != "pallas":
        raise AssertionError(f"the dissipation path ran with {env_config}")


def run_grids():
    """Phase 22: the main path at 48 points through K1's general path and
    at 512 points through K2's (``GRID_RUNS``), each checked as phase 3 and
    held to the launch counts predicted for it."""
    for label, args, predicted in GRID_RUNS:
        run_dir = args[args.index("--run_dir") + 1]
        counts = run_mbpo(args, run_dir, tuple(k for k, v in predicted.items() if v))
        print(f"   {label}: launches {json.dumps(counts)}, predicted {json.dumps(predicted)}",
              flush=True)
        if counts != predicted:
            raise AssertionError(f"the {label} path launched {counts}, predicted {predicted}")
        env_config = json.load(open(os.path.join(run_dir, "config.json")))["env_config"]
        n = json.loads(args[args.index("--env_config") + 1])["n"]
        if env_config.get("n") != n:
            raise AssertionError(f"the {label} path ran with {env_config}")


def twin_held(run):
    """What phase 21 holds of a twin run: the warmup's rewards, the first
    retrain's record and the first evaluation."""
    first = run["records"][0]
    return {"warmup rewards": run["warmup_rewards"], "val_loss": first["val_loss"],
            "elite_scores": first["elite_scores"], "epochs": first["epochs"],
            "steps": first["steps"],
            "first eval return": [run["evals"][0]["eval_return_mean"],
                                  run["evals"][0]["eval_return_std"]]}


def burgers_period_gap():
    """The perturbation of the Burgers twin's floor: the largest gap of one
    float32 Burgers control period on the card from the same period on the
    host's CPU (field and reward), over the twin's reset pool at actions
    drawn from a seed, and no less than one float32 ulp of the pool's
    largest value."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.envs.burgers import Burgers
    from tests import twin_tape as T

    config = T.TWINS["burgers"].config
    size = config["pool_size"]
    outs = {}
    for device in ("cuda", "cpu"):
        env = Burgers.create(**config["env_config"], dtype=torch.float32,
                             device=torch.device(device))
        u = torch.as_tensor(T.reset_pool(T.Tape(), env, size), dtype=torch.float32,
                            device=device)
        actions = torch.as_tensor(np.random.default_rng(0).uniform(
            -1, 1, (size,) + tuple(env.action_shape)), dtype=torch.float32, device=device)
        state, out = env.step(env._fresh(u, (size,), None), actions)
        outs[device] = (state.u.cpu().double(), out.reward.cpu().double())
        ulp = float(np.spacing(np.float32(u.abs().max().item())))
    gaps = [float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"])]
    print(f"   one Burgers period, card against the CPU: field {gaps[0]:.3e}, reward "
          f"{gaps[1]:.3e}; one ulp of the pool's largest value {ulp:.3e}", flush=True)
    return max(gaps + [ulp])


def run_twin(k1_errors, name="flagship"):
    """Phase 21 (the flagship's tape) and 23 (``latent``, ``burgers``): the
    twin's tape on the card against the port on the host."""
    import torch

    from tests import twin_tape as T

    burgers = T.TWINS[name].config["env_id"] == "BurgersEnv-v0"
    run_dir = RUN_DIR_TWIN if name == "flagship" else os.path.join(RUN_DIR_TWIN, name)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    eps = burgers_period_gap() if burgers else max(k1_errors)
    host = subprocess.Popen([sys.executable, os.path.join(HERE, "tests", "twin_tape.py"),
                             run_dir, repr(eps), name],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    card_runs = ((("card", "xla"),) if burgers
                 else (("card K1", "pallas"), ("card plain", "xla")))
    runs = {}
    try:
        for label, solver in card_runs:
            t = time.perf_counter()
            run, counts = counted_run(f"the {name} twin's learn() on the card ({solver})", lambda: (
                T.run_port(name, os.path.join(run_dir, label.replace(" ", "_")),
                           torch.device("cuda"), torch.float32, solver=solver, graphs=False)))
            if counts["K2"] or (counts["K1"] > 0) != (solver == "pallas" and not burgers):
                raise AssertionError(f"the {name} twin through {solver} launched {counts}")
            if name in TWIN_K1_LAUNCHES and solver == "pallas":
                print(f"   K1 launches {counts['K1']}, predicted {TWIN_K1_LAUNCHES[name]}",
                      flush=True)
                if counts["K1"] != TWIN_K1_LAUNCHES[name]:
                    raise AssertionError(f"the {name} twin launched K1 {counts['K1']} times, "
                                         f"predicted {TWIN_K1_LAUNCHES[name]}")
            print(f"   {label}: {time.perf_counter() - t:.2f} s", flush=True)
            runs[label] = run
        t = time.perf_counter()
        _, stderr = host.communicate(timeout=TWIN_HOST_TIMEOUT)
        if host.returncode != 0:
            raise RuntimeError(f"the twin's CPU runs failed:\n{stderr[-3000:]}")
        print(f"   the CPU runs' process ended {time.perf_counter() - t:.2f} s after the "
              f"card's runs", flush=True)
    finally:
        if host.poll() is None:
            host.kill()
            host.communicate()
    for cpu_run in ("cpu", "cpu_reordered", "cpu_perturbed"):
        with open(os.path.join(run_dir, cpu_run + ".json")) as f:
            runs[cpu_run.replace("_", " ")] = json.load(f)
    digests = {label: run["weights_digest"] for label, run in runs.items()}
    if len(set(digests.values())) != 1:
        raise AssertionError(f"the twin's runs started from other weights: {digests}")

    held_run = card_runs[0][0]
    sources = ("cpu reordered", "cpu perturbed") + (() if burgers else ("card plain",))
    ref = twin_held(runs["cpu"])
    parts = {n: {k: T.gap(twin_held(runs[n])[k], v) for k, v in ref.items()} for n in sources}
    floor = {k: sum(parts[n][k] for n in sources) for k in ref}
    held = {k: T.gap(twin_held(runs[held_run])[k], v) for k, v in ref.items()}
    if burgers:
        print(f"   the floor's sources: SAC rows reversed on the CPU; every period moved by "
              f"+-{eps:.3e} (one Burgers period's gap, card against the CPU) on the CPU",
              flush=True)
    else:
        print(f"   the floor's sources: SAC rows reversed on the CPU; every period moved by "
              f"+-{eps:.3e} (phase 2's K1 max_abs_err) on the CPU; the plain solver on the "
              f"card", flush=True)
    for k in ref:
        print(f"   {k}: {held_run} against the CPU {held[k]:.3e}, floor {floor[k]:.3e} ("
              + ", ".join(f"{n} {parts[n][k]:.3e}" for n in sources) + ")", flush=True)
    parted = [k for k in ref if held[k] > floor[k]]

    gaps = T.record_gaps(runs[held_run]["records"], runs["cpu"]["records"])
    source_gaps = {n: T.record_gaps(runs[n]["records"], runs["cpu"]["records"])
                   for n in sources}
    first_parting = None
    for i, g in enumerate(gaps):
        f_floor = {k: sum(source_gaps[n][i].get(k, 0.0) for n in sources) for k in g}
        worst = max(g, key=g.get)
        over = [k for k in g if g[k] > f_floor[k]]
        if over and first_parting is None:
            first_parting = (i, over[0], g[over[0]], f_floor[over[0]])
        print(f"   iteration {i}: largest gap {g[worst]:.3e} ({worst}; floor "
              f"{f_floor[worst]:.3e}); fields over their floor: {over or 'none'}", flush=True)
    print("   first iteration parting beyond its floor: " + (
        "none" if first_parting is None else
        f"{first_parting[0]} ({first_parting[1]} {first_parting[2]:.3e} > "
        f"{first_parting[3]:.3e})"), flush=True)
    if parted:
        raise AssertionError(f"the card's {name} run parts from the CPU beyond the float32 "
                             f"floor in {parted}")


def print_retrains(run_dir):
    """The phase times and captures of each retrain iteration of a run."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    for r in records:
        if "t_surrogate" in r:
            fields = ("t_collect", "t_surrogate", "t_fit_total", "t_imagine", "t_policy",
                      "t_pull", "t_eval", "t_capture", "graph_pool_mb")
            print(f"   retrain iteration {r['iteration']}: " + ", ".join(
                f"{k} {r[k]}" for k in fields if k in r), flush=True)


def run_burgers():
    """Phase 11: the MBPO CLI on the Burgers env; neither kernel launches."""
    t = time.perf_counter()
    counts = run_mbpo(BURGERS_ARGS, RUN_DIR_BURGERS, ())
    wall = time.perf_counter() - t
    if counts != {"K1": 0, "K2": 0}:
        raise AssertionError(f"the Burgers path launched a KS kernel: {counts}")
    records = [json.loads(line) for line in open(os.path.join(RUN_DIR_BURGERS,
                                                              "metrics.jsonl"))]
    # The warmup's env steps at batch 10 (the host clock around a phase that
    # ends in a device synchronisation).
    per_step = records[0]["t_warmup_collect"] / BURGERS_WARMUP_STEPS
    print(f"   Burgers env step (250 Heun sub-steps, B=10, replay write included): "
          f"{per_step:.4f} s; {BURGERS_ENV_STEPS} env steps of {wall:.2f} s", flush=True)


def run_offline():
    """Phase 12: generate the offline dataset through K1, then one fold of
    the capacity sweep for each of the five factories."""
    import numpy as np

    from pdecontrol_tpu_torch.evaluation import evaluate, generate

    shutil.rmtree(RUN_DIR_OFFLINE, ignore_errors=True)
    os.makedirs(RUN_DIR_OFFLINE)

    def both():
        print("   generate args: " + " ".join(GENERATE_ARGS), flush=True)
        t = time.perf_counter()
        if generate.main(GENERATE_ARGS) != 0:
            raise RuntimeError("evaluation.generate failed")
        with np.load(OFFLINE_DATA) as z:
            shapes = {k: z[k].shape for k in z.files}
            want = (OFFLINE_EPISODES, OFFLINE_EPISODE_STEPS, 1)
            if shapes["obs"][:3] != want or shapes["actions"] != want + (4,):
                raise AssertionError(f"the dataset holds {shapes}")
            if not all(np.isfinite(z[k]).all() for k in ("obs", "nxtobs", "rewards")):
                raise AssertionError("the dataset holds non-finite values")
        print(f"   generate: {shapes['obs']} obs in {time.perf_counter() - t:.2f} s "
              f"(set-up and the npz write included)", flush=True)
        for factory in FACTORIES:
            args = evaluate_args(factory)
            if factory == FACTORIES[0]:
                print("   evaluate args: " + " ".join(args), flush=True)
            t = time.perf_counter()
            if evaluate.main(args) != 0:
                raise RuntimeError(f"evaluation.evaluate failed for {factory}")
            wall = time.perf_counter() - t
            out = args[args.index("--output") + 1]
            (fold,) = json.load(open(os.path.join(out, "summary.json")))
            bad = {k: fold[k] for k in ("MSE", "nrmse_final", "val_loss")
                   if not math.isfinite(fold[k])}
            if bad:
                raise AssertionError(f"{factory}: {bad}")
            with np.load(os.path.join(out, "fold0_metrics.npz")) as z:
                missing = BATTERY_KEYS - set(z.files)
                if missing or z["nrmse"].shape != (OFFLINE_WINDOW,):
                    raise AssertionError(f"{factory}: fold0_metrics.npz lacks "
                                         f"{sorted(missing)}, nrmse {z['nrmse'].shape}")
                windows = z["states"].shape[0]
            print(f"   {factory}: {fold['train_steps']} train steps, "
                  f"{fold['train_time'] / fold['train_steps']:.4f} s per TBPTT step (B=64, "
                  f"{OFFLINE_WINDOW} steps; the fit's validation batches included), MSE "
                  f"{fold['MSE']:.6f}, nrmse_final {fold['nrmse_final']:.6f}, val_loss "
                  f"{fold['val_loss']:.6f}; battery on {windows} windows; {wall:.2f} s in all",
                  flush=True)

    _, counts = counted_run("generate + 5 x evaluate", both)
    if counts != {"K1": GENERATE_K1_LAUNCHES, "K2": 0}:
        raise AssertionError(f"the offline path launched {counts}, expected K1 "
                             f"{GENERATE_K1_LAUNCHES} times and K2 never")

    # The first factory's fold, graphed and eagerly, from one state.
    data = dict(np.load(OFFLINE_DATA))
    out = {}
    for graphs in (True, False):
        args = evaluate.build_parser().parse_args(with_args(
            evaluate_args(FACTORIES[0]),
            output=os.path.join(RUN_DIR_OFFLINE, f"fold_graphs_{graphs}")))
        split = next(evaluate.fold_splits(args, data["obs"].shape[0]))
        res = evaluate.run_fold(args, data, *split, 0, graphs=graphs)
        with np.load(os.path.join(args.output, "fold0_metrics.npz")) as z:
            out[graphs] = (res, {k: z[k] for k in z.files})
    (gres, gz), (eres, ez) = out[True], out[False]
    differ = [k for k in gres if k != "train_time" and gres[k] != eres[k]]
    differ += [k for k in gz if not np.array_equal(gz[k], ez[k])]
    if differ or gz.keys() != ez.keys():
        raise AssertionError(f"the graphed fold differs from the eager one in {differ}")
    print(f"   {FACTORIES[0]} fold 0 graphed and eager equal bitwise (val_loss, MSE and the "
          f"{len(gz)} battery arrays); seconds per TBPTT step graphed "
          f"{gres['train_time'] / gres['train_steps']:.4f} (captures included), eager "
          f"{eres['train_time'] / eres['train_steps']:.4f}", flush=True)


def run_sac():
    """Phase 7: the SAC baseline CLI through K2."""
    from pdecontrol_tpu_torch.sac import train

    shutil.rmtree(RUN_DIR_SAC, ignore_errors=True)
    print("   args: " + " ".join(SAC_ARGS), flush=True)
    t = time.perf_counter()
    rc, counts = counted_run("sac.train.main", lambda: train.main(SAC_ARGS))
    if rc != 0:
        raise RuntimeError(f"the SAC CLI returned {rc}")
    require(counts, ("K1", "K2"), "the SAC run")
    records, seen = check_records(os.path.join(RUN_DIR_SAC, "metrics.jsonl"),
                                  ("sac_qf_loss", "collect_reward_mean", "eval_return_mean"))
    if records[-1]["num_steps_sampled"] < 5000:
        raise AssertionError(f"the SAC run stopped at {records[-1]['num_steps_sampled']}")
    print(f"   {records[-1]['num_steps_sampled']} env steps in "
          f"{time.perf_counter() - t:.2f} s (set-up included)", flush=True)
    for k, vals in seen.items():
        print(f"   {k}: {vals}", flush=True)
    return counts


def sac_routes():
    """Phase 7, then: two trainers of ``SAC_ARGS`` from one state, one built
    with ``graphs=False``; after the random warmup, three chunks and two
    evaluations each must be equal bitwise, with every written tensor and
    the generator after them."""
    import torch

    from pdecontrol_tpu_torch.sac import train
    from pdecontrol_tpu_torch.utils.graphs import tensors_of

    args = train.build_parser().parse_args(with_args(SAC_ARGS, run_dir=RUN_DIR_SAC_ROUTES))
    trainers = {}
    for graphs in (True, False):
        trainer = trainers[graphs] = train.SACTrainer(args, graphs=graphs)
        trainer.run_chunk(max(args.learning_starts // args.num_envs, 1), True, 0)

    def state(t):
        return tensors_of(t.env_state, t.tr, t.pool, t.replay, t.sac_state) + [
            t.gen.get_state()]

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)

    if not equal(state(trainers[True]), state(trainers[False])):
        raise AssertionError("the two SAC trainers start from different states")
    seconds = {True: [], False: []}
    for label, call in [("chunk", lambda t: t.run_chunk(args.chunk, False,
                                                         args.updates_per_step))] * 3 + [
            ("evaluation", lambda t: t.evaluate())] * 2:
        outs = {}
        for graphs, trainer in trainers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[graphs] = call(trainer)
            torch.cuda.synchronize()
            seconds[graphs].append(time.perf_counter() - t0)
        a, b = outs[True], outs[False]
        same = a == b if isinstance(a, dict) else equal(a, b)
        if not same:
            raise AssertionError(f"a graphed SAC {label} differs from the eager one: {a}, {b}")
    graphed, eager = trainers[True], trainers[False]
    if not equal(state(graphed), state(eager)) or (
            graphed.sac_state.updates != eager.sac_state.updates):
        raise AssertionError("the graphed SAC trainer's state differs from the eager one's")
    steps = args.chunk * args.num_envs
    g, e = seconds[True], seconds[False]
    print(f"   graphed and eager SAC equal bitwise over 3 chunks of {args.chunk} env steps of "
          f"{args.num_envs} envs (one update each) and 2 evaluations; chunk seconds graphed "
          f"{[round(x, 4) for x in g[:3]]} (the first captures), eager "
          f"{[round(x, 4) for x in e[:3]]}: {steps / (sum(g[1:3]) / 2):.1f} env steps per "
          f"second graphed, {steps / (sum(e[1:3]) / 2):.1f} eager; evaluation seconds graphed "
          f"{[round(x, 4) for x in g[3:]]}, eager {[round(x, 4) for x in e[3:]]}", flush=True)


def build_controller(args, graphs=True):
    """The MBPO controller of the CLI's ``args``, on the card."""
    from pdecontrol_tpu_torch.mbrl import script
    from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController

    print("   args: " + " ".join(args) + ("" if graphs else " (graphs=False)"), flush=True)
    return PDEModelBasedController(script.config_from_args(
        script.build_parser().parse_args(args)), graphs=graphs)


def run_restart():
    """Phase 8: resume phase 3's run from its last snapshot, run two more
    iterations, and time one snapshot of the full-size state."""
    import torch

    path = os.path.join(RUN_DIR, "metrics.jsonl")
    before = [json.loads(line) for line in open(path)]
    last = before[-1]

    def resumed():
        ctl = build_controller(RESUME_ARGS)
        try:
            want = {
                "iteration": 6,
                "num_pol_updates": last["num_pol_updates"],
                "num_ensemble_updates": max(r.get("num_ensemble_updates", 0) for r in before),
                # A record counts the steps sampled before its iteration.
                "total_steps": last["num_steps_sampled"] + ctl.samples_per_iteration,
            }
            got = {
                "iteration": ctl.iteration,
                "num_pol_updates": ctl.num_pol_updates,
                "num_ensemble_updates": ctl.num_ensemble_updates,
                "total_steps": int(ctl.replay.total_steps),
            }
            print(f"   restored {json.dumps(got)}", flush=True)
            if not ctl.restored or got != want:
                raise AssertionError(f"restored {got}, phase 3 ended at {want}")
            ctl.learn()
        finally:
            ctl.logger.finish()
        return ctl

    ctl, counts = counted_run("resume + learn()", resumed)
    require(counts, ("K1",), "the resumed run")

    records, _ = check_records(path, METRICS)
    if [r.get("iteration") for r in records] != list(range(8)):
        raise AssertionError(f"metrics.jsonl holds {[r.get('iteration') for r in records]}")
    if records[:6] != before:
        raise AssertionError("the resumed run rewrote the records of the first run")
    check_fit_route(records[6:])
    for r in records[6:]:
        if "t_warmup_collect" in r or "eval_return_mean" in r:
            raise AssertionError(f"iteration {r['iteration']} warmed up or evaluated again")
        bad = {k: v for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)}
        if bad:
            raise AssertionError(f"iteration {r['iteration']}: {bad}")
        t = {k: v for k, v in r.items() if k.startswith("t_")}
        print(f"   iteration {r['iteration']}: {json.dumps(t)}", flush=True)
    backups = [f for f in os.listdir(RUN_DIR) if f.startswith("metrics.jsonl.bak")]
    if backups:
        raise AssertionError(f"the resume backed the stream up: {backups}")
    if ctl.iteration != 8 or ctl.ckpt.latest_step() != 8:
        raise AssertionError(f"ended at iteration {ctl.iteration}, snapshot "
                             f"{ctl.ckpt.latest_step()}")

    # One snapshot of the full-size state (both replays at their capacity).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctl.save_checkpoint()
    t_save = time.perf_counter() - t0
    ctl.ckpt.wait()
    t_disk = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(RUN_DIR, "checkpoints", "8.pt"))
    t0 = time.perf_counter()
    ctl.ckpt.restore(map_location="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    print(f"   checkpoint: save() returned after {t_save:.4f} s, on disk after "
          f"{t_disk:.4f} s, {size} bytes ({size / 1e6:.1f} MB); restore() to the card "
          f"{t_restore:.4f} s", flush=True)
    return ctl


def run_trace():
    """Phase 9: iterations 0 and 1 of the main path with ``--profile_dir``."""
    shutil.rmtree(RUN_DIR_TRACE, ignore_errors=True)

    def traced():
        ctl = build_controller(TRACE_ARGS)
        try:
            ctl.learn()
        finally:
            ctl.logger.finish()
        return ctl

    ctl, counts = counted_run("learn() with --profile_dir", traced)
    require(counts, ("K1",), "the traced run")
    profile = os.path.join(RUN_DIR_TRACE, "profile")
    files = sorted(os.listdir(profile)) if os.path.isdir(profile) else []
    traces = [f for f in files if f.startswith("trace-") and f.endswith(".json")]
    span_files = [f for f in files if f.startswith("spans-") and f.endswith(".jsonl")]
    if len(traces) != 1 or len(span_files) != 1 or len(files) != 2:
        raise AssertionError(f"--profile_dir must hold one trace and one spans file: {files}")
    path = os.path.join(profile, traces[0])
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    # The share of the traced iteration in which a kernel ran: the union of
    # the kernels' intervals (microseconds) over the traced region.
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and e.get("ph") == "X")
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    named = {e.get("name") for e in events if e.get("ph") == "X"}
    missing = {"iteration", "iteration.dispatch"} - named
    if missing:
        raise AssertionError(f"the trace's host rows lack the program's spans {missing}")
    stamps = sum(1 for e in events if e.get("cat") == "kernel"
                 and "device_stamp_kernel" in str(e.get("name")))
    if not stamps:
        raise AssertionError("the trace's device rows show no stamp kernel")
    # The traced region: from its first event to the end of its last.
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wall_s = (max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)) / 1e6
    with open(os.path.join(profile, span_files[0])) as f:
        lines = [json.loads(line) for line in f]
    marks = {x["stamp"] for x in lines if "stamp" in x}
    print(f"   trace {path}: {size} bytes ({size / 1e6:.1f} MB), {len(events)} events, "
          f"{stamps} stamp kernels, read back in {time.perf_counter() - t0:.2f} s; "
          f"{span_files[0]}: {sum('span' in x for x in lines)} spans, stamps "
          f"{sorted(marks)}", flush=True)
    records, _ = check_records(os.path.join(RUN_DIR_TRACE, "metrics.jsonl"),
                               ("train_loss", "sac_qf_loss", "eval_return_mean"))
    check_fit_route(records)
    t = {k: v for k, v in records[1].items() if k.startswith("t_")}
    print(f"   traced iteration 1: {wall_s:.4f} s under the profiler "
          f"{json.dumps(t)}", flush=True)
    if spans:
        # The same kernel time against phase 3's iteration 1, which ran the
        # same work untraced: from its dispatch until its record's pull, the
        # checkpoint after it (an upper bound of its device time).
        with open(os.path.join(RUN_DIR, "metrics.jsonl")) as f:
            untraced = [json.loads(line) for line in f][1]
        plain_s = untraced["t_dispatch"] + untraced["t_ready"]
        print(f"   {len(spans)} kernels ran for {busy / 1e6:.4f} s: the card was busy "
              f"{100 * busy / 1e6 / wall_s:.2f}% of the traced iteration, and "
              f"{100 * busy / 1e6 / plain_s:.2f}% of phase 3's untraced iteration 1 "
              f"(t_dispatch + t_ready {plain_s:.4f} s)", flush=True)
    else:
        print("   the trace holds no CUDA kernel: device busy share not measured", flush=True)


def time_world_forms(ctl):
    """Milliseconds of one ``imagine(3)`` of the restored main-path
    controller (its body, ``_imagine_body``, not the controller's own graph
    of it) in three forms of the world step's auto-reset: eagerly (host
    clock around work that ends in a synchronisation, mean of 3 after one
    warm-up) and, where no value goes to the host, as a CUDA graph (CUDA
    events over 5 replays).  Draws and replay writes go to the controller's
    state, which nothing reads after this phase."""
    import types

    import torch

    from pdecontrol_tpu_torch.mbrl.world import WorldModel, _pick
    from pdecontrol_tpu_torch.utils.graphs import GraphCache

    world = ctl.world

    def select_step(self, generator, state, ens, agent_action, tr, horizon, replay,
                    reset=True):
        env_action = tr.agent_to_env_action(agent_action)
        stepped, reward = self.advance(generator, state, ens,
                                       tr.env_action_to_world(env_action), tr)
        env_limit = stepped.timesteps >= self.max_episode_steps
        all_done = torch.all(env_limit | (stepped.simulated >= horizon))
        truncated = torch.broadcast_to(all_done, env_limit.shape)
        state = stepped
        if reset:
            state = _pick(all_done, self.reset(generator, ens, replay, tr), stepped)
        return state, (state.obs, reward, torch.zeros_like(truncated), truncated,
                       stepped.obs)

    def host_step(self, generator, state, ens, agent_action, tr, horizon, replay,
                  reset=True):
        env_action = tr.agent_to_env_action(agent_action)
        stepped, reward = self.advance(generator, state, ens,
                                       tr.env_action_to_world(env_action), tr)
        env_limit = stepped.timesteps >= self.max_episode_steps
        all_done = bool(torch.all(env_limit | (stepped.simulated >= horizon)))
        truncated = torch.full_like(env_limit, all_done)
        state = self.reset(generator, ens, replay, tr) if all_done else stepped
        return state, (state.obs, reward, torch.zeros_like(truncated), truncated,
                       stepped.obs)

    forms = {"port": WorldModel.step, "select": select_step, "host": host_step}
    out = {}
    try:
        for name, step in forms.items():
            world.step = types.MethodType(step, world)
            eager = []
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ctl._imagine_body(3)
                torch.cuda.synchronize()
                if i:
                    eager.append(time.perf_counter() - t0)
            graphed = None
            if name != "host":
                cache = GraphCache([ctl.gen])
                captured = cache.capture(name, lambda: ctl._imagine_body(3)[1], [])
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                captured.graph.replay()
                start.record()
                for _ in range(5):
                    captured.graph.replay()
                end.record()
                torch.cuda.synchronize()
                graphed = start.elapsed_time(end) / 5
            out[name] = (1e3 * sum(eager) / len(eager), graphed)
    finally:
        del world.step
    for name, (eager_ms, graphed_ms) in out.items():
        print(f"   world step form {name}: imagine(3) eager {eager_ms:.2f} ms, graph "
              + ("not capturable (host read)" if graphed_ms is None
                 else f"{graphed_ms:.2f} ms"), flush=True)


def run_fused_against_eager():
    """Phase 13: the main path with ``--no_fuse_iteration`` (the phases as
    graphs) and in a controller built with ``graphs=False``; each stream
    must equal phase 3's (the first 6 records: phase 8 appended 2) in every
    field that does not read the clock."""
    runs = {"--no_fuse_iteration": (EAGER_ARGS, RUN_DIR_EAGER, True),
            "graphs=False": (NO_GRAPHS_ARGS, RUN_DIR_NO_GRAPHS, False)}
    for label, (args, run_dir, graphs) in runs.items():
        counts = run_mbpo(args, run_dir, ("K1",), fused=False, graphs=graphs)
        if counts != {"K1": MAIN_K1_LAUNCHES, "K2": 0}:
            raise AssertionError(f"the {label} path launched {counts}, expected K1 "
                                 f"{MAIN_K1_LAUNCHES} times and K2 never")

    def stream(run_dir):
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f][:6]

    def strip(r):
        return {k: v for k, v in r.items() if k not in CLOCK_FIELDS and not k.startswith("t_")}

    fused = stream(RUN_DIR)
    streams = {label: stream(run_dir) for label, (_, run_dir, _) in runs.items()}
    for label, other in streams.items():
        differ = []
        for a, b in zip(fused, other):
            sa, sb = strip(a), strip(b)
            if sa.keys() != sb.keys():
                raise AssertionError(f"{label}, iteration {a['iteration']}: the fields differ "
                                     f"({sorted(sa.keys() ^ sb.keys())})")
            differ += [(a["iteration"], k, sa[k], sb[k]) for k in sa if sa[k] != sb[k]]
        if differ or len(other) != len(fused):
            raise AssertionError(f"the default and {label} streams differ: {differ}")
        print(f"   default (phase 3) and {label} streams equal in all "
              f"{sum(len(strip(r)) for r in fused)} non-clock fields of 6 records", flush=True)
    phases = ("t_collect", "t_imagine", "t_policy", "t_pull")
    graphed, eager = streams["--no_fuse_iteration"], streams["graphs=False"]
    for a, b, c in zip(fused, graphed, eager):
        times = {label: {k: r[k] for k in phases + ("t_eval",) if k in r}
                 for label, r in (("graphed phases", b), ("eager phases", c))}
        if "t_surrogate" in a:
            times = {"default": {k: a[k] for k in phases + ("t_eval",) if k in a}, **times}
            print(f"   iteration {a['iteration']} (retrain): " + "; ".join(
                f"{k} {json.dumps(v)}" for k, v in times.items()), flush=True)
            continue
        print(f"   iteration {a['iteration']} (non-retrain): fused t_dispatch "
              f"{a['t_dispatch']} s + t_ready {a['t_ready']} s = "
              f"{a['t_dispatch'] + a['t_ready']:.4f} s; graphed phases "
              f"{sum(b[k] for k in phases):.4f} s; eager phases "
              f"{sum(c[k] for k in phases):.4f} s", flush=True)


def run_fit_routes():
    """Phase 14: one retrain of phase 3's last snapshot under each fit route;
    the default route must equal ``--no_fuse_fit`` exactly."""
    import torch

    from pdecontrol_tpu_torch.utils import checkpoint as C

    shutil.rmtree(RUN_DIR_FIT, ignore_errors=True)
    snapshot = C.CheckpointManager(os.path.join(RUN_DIR, "checkpoints")).restore(
        step=SNAPSHOT_STEP, map_location="cpu")

    def routes():
        out = {}
        for name, flags in FIT_ROUTES.items():
            ctl = build_controller(with_args(FIT_ARGS, run_dir=os.path.join(
                RUN_DIR_FIT, name.replace("--", "").replace(" ", "_"))) + flags)
            try:
                C.load_controller_state(ctl, snapshot)
                ctl.update_delta_transform()
                torch.cuda.synchronize()
                before = ctl.fit_state.global_step.tolist()
                logs = ctl.update_surrogates()
                torch.cuda.synchronize()
                steps = [b - a for a, b in zip(before, ctl.fit_state.global_step.tolist())]
                st = ctl.fit_state
                state = {k: getattr(st, k).clone() for k in
                         ("params", "exp_avg", "exp_avg_sq", "count", "global_step")}
                out[name] = (logs, steps, state)
            finally:
                ctl.logger.finish()
            del ctl
            torch.cuda.empty_cache()
        return out

    n = len(FIT_ROUTES)
    out, counts = counted_run(f"{n} controllers + {n} retrains", routes)
    # Each controller's reset pool launches K1; the fits launch no kernel.
    if counts != {"K1": n * 920, "K2": 0}:
        raise AssertionError(f"phase 14 launched {counts}, expected K1 only in the {n} "
                             f"reset pools ({n * 920}) and K2 never")
    for name, (logs, steps, _) in out.items():
        total, m = logs["t_fit_total"], len(steps)
        lockstep = "--sequential_member_training" not in name
        line = (f"   {name}: t_fit_total {total:.4f} s, member steps {steps}, epochs "
                f"{logs['epochs']}, val_loss {logs['val_loss']:.6f}; "
                f"{total / sum(steps):.4f} s per member-step")
        if lockstep:
            masked = 1 - sum(steps) / (m * max(steps))
            line += (f", {total / max(steps):.4f} s per lock-step step; "
                     f"{100 * masked:.2f}% of the {m * max(steps)} computed member-steps "
                     f"were of members already stopped")
        if "t_fit_capture" in logs:
            net = total - logs["t_fit_capture"]
            per = (f"{net / max(steps):.4f} s per lock-step step" if lockstep
                   else f"{net / sum(steps):.4f} s per member-step")
            line += (f"; captures {logs['t_fit_capture']:.4f} s, pool "
                     f"+{logs['fit_graph_pool_mb']:.1f} MB, {per} without them")
        print(line + f"; {json.dumps({k: v for k, v in logs.items() if k.startswith('t_')})}",
              flush=True)
    (glogs, gsteps, gstate), (elogs, esteps, estate) = out["default"], out["--no_fuse_fit"]
    if "t_fit_capture" not in glogs or "t_fit_val" not in elogs or "t_fit_ready" in elogs:
        raise AssertionError(f"the routes' fields: {sorted(glogs)}, {sorted(elogs)}")
    if max(gsteps) != 50:
        raise AssertionError(f"the default route took {gsteps} steps, not 50")
    differ = [k for k in gstate if not torch.equal(gstate[k], estate[k])]
    differ += [k for k in ("val_loss", "elite_scores", "train_loss", "steps", "epochs")
               if glogs[k] != elogs[k]]
    if differ or gsteps != esteps:
        raise AssertionError(f"the graphed fit differs from the eager one in {differ}")
    print(f"   default (graphed) and --no_fuse_fit equal: parameters, Adam state, "
          f"global steps, val losses {glogs['elite_scores']}", flush=True)
    (slogs, ssteps, sstate), (qlogs, qsteps, qstate) = (
        out["--sequential_member_training"],
        out["--sequential_member_training --no_fuse_fit"])
    if "t_fit_capture" not in slogs or "t_fit_capture" in qlogs:
        raise AssertionError(f"the sequential routes' fields: {sorted(slogs)}, {sorted(qlogs)}")
    differ = [k for k in sstate if not torch.equal(sstate[k], qstate[k])]
    differ += [k for k in ("val_loss", "elite_scores", "train_loss", "steps", "epochs")
               if slogs[k] != qlogs[k]]
    if differ or ssteps != qsteps:
        raise AssertionError(f"the graphed sequential fit differs from its eager run in {differ}")
    print(f"   sequential graphed and eager equal: parameters, Adam state, global steps, "
          f"val losses {slogs['elite_scores']}", flush=True)


def run_native(k1_timings):
    """Phase 15: the native solver against K1 in float64, and its time."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators
    from pdecontrol_tpu_torch.utils import native

    t = time.perf_counter()
    lib = native.build()
    print(f"   {os.path.relpath(lib, HERE)}: built in {time.perf_counter() - t:.2f} s", flush=True)
    dev = torch.device("cuda")
    ops = KSOperators.create(64, 22.0, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(7)
    errors = []
    for objective in ("l2control", "dissipation"):
        u = rng.uniform(-1, 1, (10, 64)).astype(np.float32)
        phi = (0.3 * np.sin(2 * np.pi * np.arange(64) / 64)[None]
               * rng.uniform(-1, 1, (10, 1))).astype(np.float32)
        got = pallas_ks.ks_control_period(ops, torch.as_tensor(u, device=dev),
                                          torch.as_tensor(phi, device=dev), 1e-3, 250, objective)
        ref = native.ks_control_period(u.astype(np.float64), phi.astype(np.float64), ops.dx,
                                       1e-3, 250, objective)
        for name, g, r in zip(("u", "reward"), got, ref):
            holds("K1", f"against the native solver (float64), {objective} B=10 250 "
                  f"sub-steps {name}", g.double(), torch.as_tensor(r, device=dev), 1e-4, 1e-5,
                  errors)
    u = rng.uniform(-1, 1, (10, 64))
    phi = np.zeros(64)
    native.ks_control_period(u, phi, ops.dx, 1e-3, 250)
    reps = 20
    t = time.perf_counter()
    for _ in range(reps):
        native.ks_control_period(u, phi, ops.dx, 1e-3, 250)
    ms = 1e3 * (time.perf_counter() - t) / reps
    k1 = k1_timings[10]["ms"]
    print(f"   native solver (float64, one core): {ms:.4f} ms per period at B=10 (host clock, "
          f"mean of {reps}); K1 {k1:.6f} ms (phase 2): {ms / k1:.1f}x", flush=True)


def run_dryrun():
    """Phase 16: the dry run of four ranks on the card."""
    cmd = [sys.executable, "-m", "pdecontrol_tpu_torch.parallel.dryrun", "4",
           "--timeout", "240"]
    print("   " + " ".join(cmd[1:]), flush=True)
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=HERE))
    for line in proc.stdout.splitlines():
        if line.startswith("[dryrun]"):
            print("   " + line, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the dry run failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")


def run_mesh():
    """Phase 17: the mesh path as four rank processes, and at 1x1."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.mbrl import script
    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.parallel.dryrun import free_port, launch
    from pdecontrol_tpu_torch.parallel.mesh_smoke import (hold_one, iteration_walls,
                                                          sac_reorder_gaps)
    from pdecontrol_tpu_torch.utils import checkpoint as C

    shutil.rmtree(RUN_DIR_MESH, ignore_errors=True)
    shutil.rmtree(RUN_DIR_MESH_ONE, ignore_errors=True)
    logs = os.path.join(RUN_DIR_MESH, "logs")
    os.makedirs(logs)
    address = f"localhost:{free_port()}"
    cmds = [[sys.executable, "-m", "pdecontrol_tpu_torch.mbrl.script",
             *with_args(MESH_ARGS, run_dir=os.path.join(RUN_DIR_MESH, f"rank{i}")),
             "--coordinator_address", address, "--num_processes", str(MESH_RANKS),
             "--process_id", str(i)] for i in range(MESH_RANKS)]
    print("   args of rank 0: " + " ".join(cmds[0][3:]), flush=True)
    t = time.perf_counter()
    # Two CPU threads a rank: four ranks on this host's cores (a rank's
    # threads spinning against another's stall both).
    outs = launch(cmds, 420, logs, env=dict(os.environ, OMP_NUM_THREADS="2"))
    mesh_wall = time.perf_counter() - t
    ranks = [json.loads(next(line[len("[rank] "):] for line in out.splitlines()
                             if line.startswith("[rank] "))) for out in outs]

    pallas_ks.rows_launched = 0
    t = time.perf_counter()
    rc, counts = counted_run("script.main at 1x1", lambda: script.main(MESH_ONE_ARGS))
    one_wall = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"the 1x1 run failed (script.main returned {rc})")
    one_rows = pallas_ks.rows_launched

    for r in ranks:
        fit = r["graphs"].get("fit", {})
        print(f"   rank {r['rank']}: {r['device']}, backend {r['backend']}, envs "
              f"{r['env_rows'][0]}:{r['env_rows'][1]}, K1 {r['K1']} launches of "
              f"{r['K1_rows']} rows, K2 {r['K2']}, peak allocated {r['peak_allocated_mb']} MB; "
              f"the graphed fit: t_fit_capture {fit.get('t_capture')} s, fit_graph_pool_mb "
              f"{fit.get('graph_pool_mb')}, the last retrain's t_fit_total "
              f"{r['t_fit_total']} s", flush=True)
        if r["backend"] != "gloo" or r["device"] != "cuda:0":
            raise AssertionError(f"rank {r['rank']} ran on {r['device']} through {r['backend']}")
        # gloo's collectives run on the host: only the fits replay graphs.
        if r["routes"] != {"fused": False, "phases": False, "fit": True} or set(
                r["graphs"]) != {"fit"} or {k[0] for k in fit["keys"]} != {"fit_step", "fit_val"}:
            raise AssertionError(f"rank {r['rank']} took the routes {r['routes']} and captured "
                                 f"{r['graphs']}")
    print("   every rank replays the lock-step fit's graphs; the fused iteration, the phases "
          "and the evaluations run eagerly (gloo's collectives run on the host)", flush=True)
    for label, k1, rows in [(f"rank {r['rank']}", r["K1"], r["K1_rows"]) for r in ranks] + [
            ("1x1", counts["K1"], one_rows)]:
        per = (rows - MESH_OTHER_ROWS) / (k1 - MESH_K1_LAUNCHES + MESH_COLLECT_LAUNCHES)
        want = 10 if label != "1x1" else 20
        print(f"   {label}: K1 {k1} launches, {per:.1f} rows per collect launch", flush=True)
        if k1 != MESH_K1_LAUNCHES or per != want:
            raise AssertionError(f"{label} launched K1 {k1} times at {per} rows per collect "
                                 f"launch, expected {MESH_K1_LAUNCHES} at {want}")
    print(f"   K1 launches on the 4 ranks: {sum(r['K1'] for r in ranks)} in all", flush=True)

    primary = os.path.join(RUN_DIR_MESH, "rank0")
    written = sorted(os.listdir(primary))
    others = [d for d in (f"rank{i}" for i in range(1, MESH_RANKS))
              if os.path.exists(os.path.join(RUN_DIR_MESH, d))]
    if not {"metrics.jsonl", "config.json", "checkpoints"} <= set(written) or others:
        raise AssertionError(f"the primary wrote {written}; the other ranks wrote {others}")
    print(f"   files: rank 0 wrote {written}; ranks 1-3 wrote nothing", flush=True)

    snaps = [C.CheckpointManager(os.path.join(d, "checkpoints")).restore(map_location="cpu")
             for d in (primary, RUN_DIR_MESH_ONE)]
    warmup = (slice(0, 20), slice(0, 250))
    for k in ("obs_seq", "actions", "rewards", "steps", "truncated"):
        a, b = (s["replay"][k][warmup] for s in snaps)
        if not torch.equal(a, b):
            raise AssertionError(f"the warmup's replay {k} differs from the 1x1 run's: "
                                 f"{float((a.double() - b.double()).abs().max()):.3e}")
    print("   the random warmup's replay (20 envs x 250 steps) equals the 1x1 run's bitwise",
          flush=True)

    mesh_recs = check_records(os.path.join(primary, "metrics.jsonl"), MESH_METRICS)[0]
    one_recs = check_records(os.path.join(RUN_DIR_MESH_ONE, "metrics.jsonl"), MESH_METRICS)[0]
    held, worst = hold_one(mesh_recs, one_recs)
    print(f"   iteration 0 agrees with 1x1 on {', '.join(held)} (rtol 2e-4, atol 1e-7)",
          flush=True)
    floor = sac_reorder_gaps()
    print("   iteration 0 after its 200 SAC updates, relative gap to 1x1: " + ", ".join(
        f"{k} {g:.3e}" for (later, k), (g, _) in sorted(worst.items()) if not later)
        + "; one process reversing the rows of each SAC batch: " + ", ".join(
        f"{k} {g:.3e}" for k, g in floor.items()), flush=True)
    worst = {k: v for (later, k), v in worst.items() if later}
    print("   iterations 1-5, largest relative gap to 1x1 (not held: float32 SAC on a "
          "chaotic system): " + ", ".join(f"{k} {g:.3e} (iteration {i})"
                                         for k, (g, i) in sorted(worst.items())), flush=True)
    print(f"   iteration wall times, mesh (eager phases, graphed fit, 4 ranks sharing the "
          f"card): {iteration_walls(mesh_recs)} s; 1x1 (fused, graphs): "
          f"{iteration_walls(one_recs)} s", flush=True)
    print(f"   wall: mesh {mesh_wall:.2f} s (4 processes, start-up included), 1x1 "
          f"{one_wall:.2f} s (in this process)", flush=True)
    return ranks


def run_nccl_one():
    """Phase 18: a process group of one NCCL rank on the card
    (``mesh_smoke.py one``), its ``all_reduce`` captured and replayed."""
    cmd = [sys.executable, "-m", "pdecontrol_tpu_torch.parallel.mesh_smoke", "one"]
    print("   " + " ".join(cmd[1:]), flush=True)
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=180,
                          env=dict(os.environ, PYTHONPATH=HERE))
    if proc.returncode != 0:
        raise RuntimeError(f"the NCCL rank failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"   {r['backend']} on {r['device']}, world size {r['world_size']}: the body's "
          f"all_reduce captured in {r['t_capture']} s; {r['replays']} replays on fresh "
          f"inputs, each equal to the eager body bit for bit: {r['equal']}", flush=True)
    if not (r["backend"] == "nccl" and r["captured"] and r["equal"] == [True] * r["replays"]):
        raise AssertionError(f"the NCCL capture: {r}")


def long_horizon(iteration):
    """``LONG_SCHEDULE``'s horizon at an iteration, as the controller
    truncates it."""
    sch = LONG_SCHEDULE
    frac = min(max((iteration - sch["start"]) / (sch["stop"] - sch["start"]), 0.0), 1.0)
    return int(sch["vmin"] + frac * (sch["vmax"] - sch["vmin"]))


def run_long_route(args, graphs):
    """One route of phase 19: ``learn()`` of a controller of ``args``,
    with each retrain's steps per member noted (the members' global steps
    before and after it).  Returns what the phase compares."""
    import torch

    ctl = build_controller(args, graphs=graphs)
    fits = []
    update = ctl.update_surrogates

    def noted_update():
        before = ctl.fit_state.global_step.tolist()
        logs = update()
        fits.append([b - a for a, b in zip(before, ctl.fit_state.global_step.tolist())])
        return logs

    ctl.update_surrogates = noted_update
    t = time.perf_counter()
    try:
        ctl.learn()
    finally:
        ctl.logger.finish()
    wall = time.perf_counter() - t
    st = ctl.fit_state
    out = {
        "wall": wall, "fits": fits, "graphs": ctl.graph_summary(),
        "world_rows": (int(ctl.world_replay.next_row), ctl.world_replay.num_rows),
        "fit_state": {k: getattr(st, k).clone() for k in
                      ("params", "exp_avg", "exp_avg_sq", "count", "global_step")},
        "peak_mb": torch.cuda.max_memory_allocated() / 1e6,
    }
    del ctl
    torch.cuda.empty_cache()
    return out


def check_long_graphs(out):
    """The default route captured a fused graph for every horizon of
    ``LONG_HORIZONS`` and replayed each, and the fit's graphs; the phase
    route a ``("world", horizon, rounds)`` graph for each, replayed."""
    def by_horizon(label, route, key_horizon):
        got = out[label]["graphs"].get(route, {"keys": [], "replays": [], "t_capture": 0.0,
                                               "graph_pool_mb": 0.0})
        replays = {key_horizon(k): n for k, n in zip(got["keys"], got["replays"])}
        replays.pop(None, None)
        if sorted(replays) != list(LONG_HORIZONS) or min(replays.values()) < 1:
            raise AssertionError(f"{label}: the {route} graphs by horizon were replayed "
                                 f"{replays} times; every horizon of {LONG_HORIZONS} must "
                                 f"be captured and replayed")
        print(f"   {label}: {route} graphs by horizon, replays {json.dumps(replays)}; "
              f"captures {got['t_capture']:.2f} s, pool +{got['graph_pool_mb']:.1f} MB",
              flush=True)

    by_horizon("default", "fused", lambda k: k[1] if isinstance(k[0], int) else None)
    by_horizon("--no_fuse_iteration --no_fuse_fit", "phases",
               lambda k: k[1] if k[0] == "world" else None)
    fit = out["default"]["graphs"].get("fit", {"keys": [], "replays": []})
    if not fit["replays"] or min(fit["replays"]) < 1:
        raise AssertionError(f"the default route's fit graphs: {fit}")
    print(f"   default: fit graphs {fit['keys']}, replays {fit['replays']}", flush=True)


def run_long():
    """Phase 19: what only a long run reaches (see ``LONG_ARGS``) on the
    three routes; their streams, fits and world replays must agree."""
    import torch

    out = {}
    for label, (flags, graphs) in LONG_ROUTES.items():
        run_dir = os.path.join(RUN_DIR_LONG, label.replace("--", "").replace(" ", "_")
                               .replace("=", "_"))
        shutil.rmtree(run_dir, ignore_errors=True)
        torch.cuda.reset_peak_memory_stats()
        route, counts = counted_run(label, lambda: run_long_route(
            with_args(LONG_ARGS, run_dir=run_dir) + flags, graphs))
        if counts != {"K1": LONG_K1_LAUNCHES, "K2": 0}:
            raise AssertionError(f"the {label} route launched {counts}, expected K1 "
                                 f"{LONG_K1_LAUNCHES} times and K2 never")
        records, _ = check_records(os.path.join(run_dir, "metrics.jsonl"), METRICS)
        iters = [r for r in records if "iteration" in r]
        horizons = [r["horizon"] for r in iters]
        if horizons != [long_horizon(i) for i in range(LONG_ITERATIONS)]:
            raise AssertionError(f"the {label} route ran the horizons {horizons}")
        check_route(iters, fused=not flags, graphs=graphs, eager_fit="--no_fuse_fit" in flags)
        next_row, num_rows = route["world_rows"]
        if next_row <= num_rows:
            raise AssertionError(f"the {label} route's world replay did not wrap: next_row "
                                 f"{next_row}, {num_rows} rows")
        route["records"] = records
        out[label] = route
        print(f"   {label}: {route['wall']:.2f} s for {LONG_ITERATIONS} iterations, world "
              f"replay next_row {next_row} of {num_rows} rows, peak allocated "
              f"{route['peak_mb']:.1f} MB", flush=True)

    check_long_graphs(out)
    default = out["default"]

    def strip(r):
        return {k: v for k, v in r.items() if k not in CLOCK_FIELDS and not k.startswith("t_")}

    for label, route in out.items():
        if label == "default":
            continue
        a, b = default["records"], route["records"]
        differ = [(x.get("iteration"), k, sx[k], sy.get(k))
                  for x, y in zip(a, b) for sx, sy in [(strip(x), strip(y))]
                  for k in sx.keys() | sy.keys() if sx.get(k) != sy.get(k)]
        if differ or len(a) != len(b):
            raise AssertionError(f"the default and {label} streams differ: {differ[:10]}")
        if route["fits"] != default["fits"] or route["world_rows"] != default["world_rows"]:
            raise AssertionError(f"{label}: member steps {route['fits']}, world rows "
                                 f"{route['world_rows']}; the default's {default['fits']}, "
                                 f"{default['world_rows']}")
        differ = [k for k, v in default["fit_state"].items()
                  if not torch.equal(v, route["fit_state"][k])]
        if differ:
            raise AssertionError(f"the default route's graphed fits and {label}'s differ in "
                                 f"{differ}")
        print(f"   default and {label} equal: all {sum(len(strip(r)) for r in a)} non-clock "
              f"fields of {len(a)} records, the members' steps, parameters and Adam state",
              flush=True)

    stopped = 0
    for i, steps in enumerate(default["fits"]):
        m, most = len(steps), max(steps)
        stopped += min(steps) < most
        print(f"   retrain {i}: member steps {steps}; {100 * (1 - sum(steps) / (m * most)):.2f}% "
              f"of the {m * most} computed member-steps were of members already stopped",
              flush=True)
    if not stopped:
        raise AssertionError(f"no member stopped before the others: {default['fits']}")
    # A record's t_ready spans the next iteration's dispatch, and so its
    # capture where it made one: those are left out.
    pulls = {}
    records = default["records"]
    for r, nxt in zip(records, records[1:]):
        if "t_dispatch" in r and "t_ready" in r and "t_capture" not in nxt:
            pulls.setdefault(r["horizon"], []).append(round(r["t_dispatch"] + r["t_ready"], 4))
    print(f"   default route, dispatch to pull by horizon where the next iteration did not "
          f"capture (s): {json.dumps(pulls)}", flush=True)


def main() -> int:
    start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "pdecontrol_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to test", file=sys.stderr)
        return 1
    print(card(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for module in ("matplotlib", "PIL"):
        print(f"{module}: {'present' if has_module(module) else 'absent'}", flush=True)

    import pdecontrol_tpu_torch  # noqa: F401  (turns TF32 off)

    t0 = phase("1 build K1 and K2")
    build_kernels()
    done("1 build K1 and K2", t0)

    t0 = phase("2 K1 against the plain version")
    k1_errors, k1_grid_errors = [], []
    k1_timings = check_kernel(k1_errors)
    k1_grid_timings = check_kernel_grids(k1_grid_errors)
    done("2 K1 against the plain version", t0)

    t0 = phase("3 main path (float32, K1)")
    torch.cuda.reset_peak_memory_stats()
    k1_counts = run_mbpo(MAIN_ARGS, RUN_DIR, ("K1",))
    if k1_counts["K1"] != MAIN_K1_LAUNCHES:
        raise AssertionError(f"the main path launched K1 {k1_counts['K1']} times, "
                             f"expected {MAIN_K1_LAUNCHES}")
    print_retrains(RUN_DIR)
    print(f"   peak allocated {torch.cuda.max_memory_allocated() / 1e6:.1f} MB, reserved "
          f"{torch.cuda.memory_reserved() / 1e6:.1f} MB after the path", flush=True)
    done("3 main path (float32, K1)", t0)

    t0 = phase("4 K2 against the plain version")
    k2_errors, k2_grid_errors = [], []
    k2_timings = check_limb_kernel(k2_errors, k1_errors)
    k2_grid_timings = check_limb_kernel_grids(k2_grid_errors, k1_grid_errors)
    done("4 K2 against the plain version", t0)

    t0 = phase("5 attractor gate")
    gate_routes()
    run_gate()
    done("5 attractor gate", t0)

    t0 = phase("6 bf16_3x MBPO path (K2)")
    k2_counts = run_mbpo(BF16_ARGS, RUN_DIR_BF16, ("K1", "K2"), evals=BF16_EVALS)
    done("6 bf16_3x MBPO path (K2)", t0)

    t0 = phase("7 SAC baseline CLI (K2)")
    run_sac()
    sac_routes()
    done("7 SAC baseline CLI (K2)", t0)

    t0 = phase("8 restart (resume the main path)")
    restarted = run_restart()
    done("8 restart (resume the main path)", t0)

    t0 = phase("9 trace (--profile_dir)")
    run_trace()
    done("9 trace (--profile_dir)", t0)

    t0 = phase("10 latent path (KSLatentConvolutionalLSTM, K1)")
    latent_counts = run_mbpo(LATENT_ARGS, RUN_DIR_LATENT, ("K1",))
    if latent_counts != {"K1": MAIN_K1_LAUNCHES, "K2": 0}:
        raise AssertionError(f"the latent path launched {latent_counts}, expected K1 "
                             f"{MAIN_K1_LAUNCHES} times and K2 never")
    done("10 latent path (KSLatentConvolutionalLSTM, K1)", t0)

    t0 = phase("11 Burgers path (plain solver)")
    run_burgers()
    done("11 Burgers path (plain solver)", t0)

    t0 = phase("12 offline (generate, evaluate x 5 factories)")
    run_offline()
    done("12 offline (generate, evaluate x 5 factories)", t0)

    t0 = phase("13 fused against eager (--no_fuse_iteration)")
    time_world_forms(restarted)
    run_fused_against_eager()
    done("13 fused against eager (--no_fuse_iteration)", t0)

    t0 = phase("14 lock-step fit against one-after-another")
    run_fit_routes()
    done("14 lock-step fit against one-after-another", t0)
    print(f"== phases 1-14: {time.perf_counter() - start:.2f} s in all", flush=True)
    t15 = time.perf_counter()

    t0 = phase("15 native solver against K1")
    run_native(k1_timings)
    done("15 native solver against K1", t0)

    t0 = phase("16 dry run, 4 ranks on the card")
    run_dryrun()
    done("16 dry run, 4 ranks on the card", t0)

    t0 = phase("17 mesh 2x2 (mbpo_ks_mesh.sh, K1)")
    run_mesh()
    done("17 mesh 2x2 (mbpo_ks_mesh.sh, K1)", t0)

    t0 = phase("18 one NCCL rank, its all_reduce captured")
    run_nccl_one()
    done("18 one NCCL rank, its all_reduce captured", t0)
    print(f"== phases 15-18: {time.perf_counter() - t15:.2f} s; phases 1-18: "
          f"{time.perf_counter() - start:.2f} s in all", flush=True)

    t0 = phase("19 what only a long run reaches")
    run_long()
    done("19 what only a long run reaches", t0)
    print(f"== phases 1-19: {time.perf_counter() - start:.2f} s in all", flush=True)

    t0 = phase("20 dissipation channel (objective \"\", K1)")
    run_dissipation()
    done("20 dissipation channel (objective \"\", K1)", t0)
    print(f"== phases 1-20: {time.perf_counter() - start:.2f} s in all", flush=True)

    t0 = phase("21 the twin on the card")
    run_twin(k1_errors)
    done("21 the twin on the card", t0)
    print(f"== phases 1-21: {time.perf_counter() - start:.2f} s in all", flush=True)

    t0 = phase("22 the main path at 48 and 512 points (general K1, K2)")
    run_grids()
    done("22 the main path at 48 and 512 points (general K1, K2)", t0)
    print(f"== phases 1-22: {time.perf_counter() - start:.2f} s in all", flush=True)

    t0 = phase("23 the latent and Burgers twins on the card")
    for name in ("latent", "burgers"):
        run_twin(k1_errors, name)
    done("23 the latent and Burgers twins on the card", t0)
    print(f"== phases 1-23: {time.perf_counter() - start:.2f} s in all", flush=True)
    for (n, b), t in sorted(k1_grid_timings.items()):
        print(f"   K1 general path n={n} B={b}: {json.dumps(t)}", flush=True)
    for (n, b), t in sorted(k2_grid_timings.items()):
        print(f"   K2 bf16_3x general path n={n} B={b}: {json.dumps(t)}", flush=True)

    print(json.dumps({"kernels": [
        {
            "name": "ks_control_period",
            "route": "cuda",
            "source": "pdecontrol_tpu_torch/csrc/ks_control_period.cu",
            "replaces": "pdecontrol_tpu/ops/pallas_ks.py:100",
            "launches": k1_counts["K1"],
            "max_abs_err": max(k1_errors + k1_grid_errors),
            **k1_timings[10],
            "library_ms": None,
        },
        {
            "name": "ks_control_period_limb",
            "route": "cuda",
            "source": "pdecontrol_tpu_torch/csrc/ks_control_period_limb.cu",
            "replaces": "pdecontrol_tpu/ops/pallas_ks_packed.py:213",
            "launches": k2_counts["K2"],
            "max_abs_err": max(k2_errors + k2_grid_errors),
            **k2_timings["bf16_3x", 10],
            "library_ms": None,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
