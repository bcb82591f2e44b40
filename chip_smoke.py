#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Three phases, each timed:

  1. build — compile kernel K1 (``pdecontrol_tpu_torch/csrc/
     ks_control_period.cu``) from the checkout's sources with nvcc;
  2. K1 against its plain PyTorch version on the card, float32, both
     objectives: 20 sub-steps at batch 12 and 8 (rtol 2e-5, atol 2e-6, the
     tolerance of ``tests/test_pallas_ks.py``); 3 periods x 25 sub-steps
     through ``env.step`` at batch 8 and for one unbatched [64] state
     (rtol 3e-5, atol 3e-6, ``tests/test_env_solvers.py``); one full
     250-sub-step period at batch 10 and 1024 (max abs error printed, held
     to rtol 1e-4, atol 1e-5); then K1's and the plain version's time per
     period at batch 10 and 1024 (CUDA events);
  3. the main path — ``pdecontrol_tpu_torch.mbrl.script.main`` with the
     flagship arguments of ``runscripts/mbpo_ks.sh`` and ``--solver pallas``
     for a few iterations (see ``MAIN_ARGS``), then checks that K1 ran
     during ``learn()``, that every logged loss and return is finite and
     that ``metrics.jsonl`` exists.

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, or when any phase
fails, it exits non-zero and prints no result.
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

# runscripts/mbpo_ks.sh with --solver pallas.  Cut from the flagship:
# total_timesteps 50000 -> 5060 (6 iterations after the 5000-step warmup),
# surrogate_train_freq 500 -> 30 (retrains at iterations 0 and 3), the
# trainer's max_steps 2000/250 -> 20/10, and --checkpoint_freq 200 dropped
# (checkpointing is not ported).  With agent_eval_freq 50, iteration 0 runs
# the one policy and surrogate evaluation of the run.
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
    "--solver", "pallas",
    "--run_dir", RUN_DIR,
]


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


def check_kernel(errors):
    """Phase 2: K1 against the plain version; returns the timings."""
    import numpy as np
    import torch

    from pdecontrol_tpu_torch.envs.kuramoto import EnvState, KuramotoSivashinsky
    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    dev = torch.device("cuda")
    ops = KSOperators.create(64, 22.0, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def compare(label, got, ref, rtol, atol):
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        errors.append(err)
        ok = bool(torch.allclose(got, ref, rtol=rtol, atol=atol))
        print(f"   {label}: max abs err {err:.3e} (rtol {rtol}, atol {atol}) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"K1 disagrees with the plain version: {label}")

    x = np.arange(64)
    for objective in ("l2control", "dissipation"):
        for b in (12, 8):
            u = tensor(rng.uniform(-1, 1, (b, 64)))
            phi = tensor(np.repeat(0.3 * np.sin(2 * np.pi * x / 64)[None], b, 0))
            got = pallas_ks.ks_control_period(ops, u, phi, 1e-3, 20, objective)
            ref = pallas_ks.ks_control_period_plain(ops, u, phi, 1e-3, 20, objective)
            for name, g, r in zip(("u", "reward"), got, ref):
                compare(f"{objective} B={b} 20 sub-steps {name}", g, r, 2e-5, 2e-6)

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

        for b in (10, 1024):
            u = tensor(rng.uniform(-1, 1, (b, 64)))
            phi = tensor(rng.uniform(-0.5, 0.5, (b, 64)))
            got = pallas_ks.ks_control_period(ops, u, phi, 1e-3, 250, objective)
            ref = pallas_ks.ks_control_period_plain(ops, u, phi, 1e-3, 250, objective)
            for name, g, r in zip(("u", "reward"), got, ref):
                compare(f"{objective} B={b} 250 sub-steps {name}", g, r, 1e-4, 1e-5)

    timings = {}
    for b in (10, 1024):
        u = tensor(rng.uniform(-1, 1, (b, 64)))
        phi = tensor(rng.uniform(-0.5, 0.5, (b, 64)))
        # Plain, kernel, kernel, plain: the two versions alternate.
        p1 = time_period(lambda: pallas_ks.ks_control_period_plain(
            ops, u, phi, 1e-3, 250, "l2control"), 3)
        k1 = time_period(lambda: pallas_ks.ks_control_period(
            ops, u, phi, 1e-3, 250, "l2control"), 50)
        k2 = time_period(lambda: pallas_ks.ks_control_period(
            ops, u, phi, 1e-3, 250, "l2control"), 50)
        p2 = time_period(lambda: pallas_ks.ks_control_period_plain(
            ops, u, phi, 1e-3, 250, "l2control"), 3)
        timings[b] = (min(k1, k2), min(p1, p2))
        print(f"   per control period (250 sub-steps) at B={b}: K1 {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms", flush=True)
    return timings


def run_main_path():
    """Phase 3: the port's CLI entry point for a few iterations."""
    from pdecontrol_tpu_torch.mbrl import script
    from pdecontrol_tpu_torch.ops import pallas_ks

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    print("   args: " + " ".join(MAIN_ARGS), flush=True)
    pallas_ks.launch_count = 0
    rc = script.main(MAIN_ARGS)
    launches = pallas_ks.launch_count
    if rc != 0:
        raise RuntimeError(f"learn() failed (script.main returned {rc})")
    print(f"   K1 launches during the run: {launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the main path never launched K1")

    path = os.path.join(RUN_DIR, "metrics.jsonl")
    if not os.path.exists(path):
        raise AssertionError(f"{path} was not written")
    records = [json.loads(line) for line in open(path)]
    iters = [r for r in records if "iteration" in r]
    checked = ("train_loss", "val_loss", "sac_qf_loss", "sac_policy_loss",
               "eval_return_mean", "collect_reward_mean", "imagined_reward_mean",
               "world_return_mean", "surrogate_open_loop_mse")
    seen = {k: [r[k] for r in records if k in r] for k in checked}
    for k, vals in seen.items():
        if not vals:
            raise AssertionError(f"no {k} was logged")
        if not all(isinstance(v, (int, float)) and math.isfinite(v) for v in vals):
            raise AssertionError(f"{k} not finite: {vals}")
    retrains = sum(1 for r in records if "num_ensemble_updates" in r)
    if len(iters) != 6 or retrains < 2:
        raise AssertionError(f"{len(iters)} iterations, {retrains} retrains")
    for r in iters:
        t = {k: v for k, v in r.items() if k.startswith("t_")}
        print(f"   iteration {r['iteration']}: {json.dumps(t)} "
              f"env_steps_per_sec {r['env_steps_per_sec']:.2f}", flush=True)
    first = records[0]
    print(f"   warmup: t_warmup_collect {first['t_warmup_collect']} s, "
          f"t_warmup_eval {first['t_warmup_eval']} s", flush=True)
    for k, vals in seen.items():
        print(f"   {k}: {vals}", flush=True)
    return launches


def main() -> int:
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

    import pdecontrol_tpu_torch  # noqa: F401  (turns TF32 off)
    from pdecontrol_tpu_torch.ops import pallas_ks

    t0 = phase("1 build K1")
    tb = time.perf_counter()
    pallas_ks.build()
    print(f"   build seconds: {time.perf_counter() - tb:.2f}", flush=True)
    done("1 build K1", t0)

    t0 = phase("2 K1 against the plain version")
    errors = []
    timings = check_kernel(errors)
    done("2 K1 against the plain version", t0)

    t0 = phase("3 main path")
    launches = run_main_path()
    done("3 main path", t0)

    ms, plain_ms = timings[10]
    print(json.dumps({"kernels": [{
        "name": "ks_control_period",
        "route": "cuda",
        "source": "pdecontrol_tpu_torch/csrc/ks_control_period.cu",
        "replaces": "pdecontrol_tpu/ops/pallas_ks.py:100",
        "launches": launches,
        "max_abs_err": max(errors),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
