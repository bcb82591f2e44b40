"""Window driver: MBPO iterations that do not retrain, back to back, as the
loop runs them (``PDEModelBasedController._run_iteration`` on the fused
iteration: on the card one CUDA-graph replay each, its record pulled one
iteration late).

Traffic keys: ``horizon`` (the imagined rollouts' length, which the
traffic's ``args`` give the schedule); ``check_iterations`` (the iteration
of the window that the reference repeats is drawn from the seed among the
first that many); ``traced_iterations`` (how many of the window's first
iterations run under the profiler in a traced run); ``layer_replays`` (how
many replays of each phase graph time a layer after the window).

Set-up: the controller from the seed, the configuration's random warmup
through the env, the delta scaling refitted over it, one eager iteration
and the iteration that captures the graph.  Then the window, closed by the
synchronised pull of its last iteration's record.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmarks.harness import compare, report, snapshot
from benchmarks.harness.cell import env_config
from benchmarks.harness.stand_in import planted
from benchmarks.harness.tracing import TracedSpan
from benchmarks.reference import mbpo
from benchmarks.reference.surrogate import FAMILIES


def reference_config(ctl, horizon: int) -> Dict:
    cfg = ctl.config
    return {
        "env": env_config(ctl.env), "horizon": horizon, "rounds": ctl.world_rounds,
        "world_batch": cfg.model_rollouts_batch_size, "tau": ctl.tau,
        "mode": FAMILIES[cfg.factory], "delta": ctl.env.delta,
        "updates": ctl.num_pol_updates_per_iteration, "policy_batch": cfg.policy_batch_size,
        "gamma": cfg.gamma, "sac_tau": cfg.sac_tau, "alpha": cfg.alpha, "lr": cfg.lr,
        "reward_scale": cfg.reward_scale,
        "target_update_interval": cfg.target_update_interval,
    }


def run(cell, t_process: float) -> Dict:
    tr = cell.traffic
    horizon = int(tr["horizon"])
    ctl = cell.controller()
    cfg = ctl.config
    cuda = ctl.device.type == "cuda"

    # ---- set-up
    ctl.collect(max(cfg.learning_starts // cfg.num_envs, 1), random=True)
    ctl.update_delta_transform()
    refit = snapshot.copy({"replay": snapshot.replay(ctl.replay), "u": ctl.env_state.u})
    ctl.iteration = 1  # iteration 0 retrains; the window's iterations do not
    for _ in range(2):  # eager, then captured and replayed
        if ctl._fused_key() is None or int(ctl.schedule(iteration=ctl.iteration)) != horizon:
            raise ValueError(f"iteration {ctl.iteration} is not a fused horizon-{horizon} one")
        ctl._run_iteration()
    ctl._flush_pending_log()
    n_setup = len(ctl.logger.records)
    live = snapshot.loop(ctl)
    pre_buf, post_buf = snapshot.Pinned(live), snapshot.Pinned(live)
    k = int(np.random.default_rng(cell.seed).integers(1, int(tr["check_iterations"]) + 1))
    ctl._sync()
    setup_s = time.perf_counter() - t_process

    # ---- window
    traced = int(tr["traced_iterations"]) if cell.trace else 0
    span = TracedSpan() if traced else None
    walls, n, stopping = [], 0, 0.0
    t0 = last = time.perf_counter()
    if span is not None:
        span.start()
    # The profiler's stop, which gathers its events, is not the window's.
    while n < k or time.perf_counter() - t0 - stopping < cell.seconds:
        if n + 1 == k:
            gen_state, updates = ctl.gen.get_state(), ctl.sac_state.updates
            pre = pre_buf.take(live)
        ctl._run_iteration()
        n += 1
        if n == k:
            post = post_buf.take(live)
        if n == traced:
            stopping = span.stop()
        now = time.perf_counter()
        walls.append(now - last)
        last = now
    ctl._flush_pending_log()
    ctl._sync()
    window_s = time.perf_counter() - t0
    if span is not None and n < traced:
        span.stop()
    peak = torch.cuda.max_memory_allocated(ctl.device) if cuda else 0
    # Under the profiler the traced iterations' host times are its own:
    # the loop's per-layer times are read from the rest of the window.
    records = ctl.logger.records
    out = {
        "setup_s": setup_s, "attempted": n, "failed": 0, "memory_peak_bytes": peak,
        "e2e": {"env_steps_per_s": n * ctl.samples_per_iteration / window_s},
    }
    if span is not None:
        out["trace"] = span.summary()
        out["per_layer"] = report.read_layers(cell, {
            "ctl": ctl, "traffic": tr, "setup": records[:n_setup],
            "window": records[n_setup + traced:], "walls": walls[traced:],
            "trace": out["trace"], "traced": records[n_setup: n_setup + min(n, traced)]})

    # ---- the comparison, once the program's state is freed
    ref_cfg, device = reference_config(ctl, horizon), ctl.device
    del ctl, live
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    pre, post = snapshot.to(pre, device), snapshot.to(post, device)
    pre["sac"]["updates"] = updates
    out["inputs"] = {"pre": pre, "post": post, "refit": snapshot.to(refit, device),
                     "gen": gen_state, "cfg": ref_cfg, "device": device}
    out["values"] = check(out["inputs"])
    return out


def reference_state(pre: Dict, refit: Dict, delta: float) -> Dict:
    """The reference's state before the checked iteration: the program's
    replays, envs, networks and optimizer states, with the two scalings
    worked out again from the observations."""
    st = dict(pre)
    st["vmin"], st["vmax"] = mbpo.obs_scaling(pre["replay"], pre["u"])
    rvmin, rvmax = mbpo.obs_scaling(refit["replay"], refit["u"])
    st["d_mean"], st["d_std"] = mbpo.delta_scaling(refit["replay"], rvmin, rvmax, delta)
    return st


def check(inputs: Dict, stand_in: Optional[str] = None) -> Dict[str, float]:
    """Repeat the checked iteration with the plain reference from the
    program's state before it, on the same draws, and measure the gaps of
    the program's state after it, or of a stand-in's (``harness/stand_in.py``)."""
    pre, cfg, device = inputs["pre"], inputs["cfg"], inputs["device"]
    it = mbpo.Iteration(cfg, device)
    state = reference_state(pre, inputs["refit"], cfg["delta"])

    def repeat():
        gen = torch.Generator(device=device)
        gen.set_state(inputs["gen"])
        return it.iterate(state, gen)

    if "ref" not in inputs:
        inputs["ref"] = repeat()
    post = inputs["post"]
    if stand_in is not None:
        with planted(stand_in):
            post = repeat()
    return gaps(pre, post, inputs["ref"])


def gaps(pre: Dict, post: Dict, ref: Dict) -> Dict[str, float]:
    """``env_gap``: the envs' fields and the replay's frames and rewards;
    ``world_gap``: the imagined replay's frames (over the largest frame the
    iteration wrote), rewards and actions; ``sac_change_gap``: the worst
    leaf's gap of the norm of its change over the iteration's updates."""
    env_gap = max(compare.max_gap(post["u"], ref["u"]),
                  compare.max_gap(post["replay"]["obs_seq"], ref["replay"]["obs_seq"]),
                  compare.max_gap(post["replay"]["rewards"], ref["replay"]["rewards"]))
    w, rw = post["world_replay"], ref["world_replay"]
    written = rw["obs_seq"] != pre["world_replay"]["obs_seq"]
    world_gap = max(compare.max_gap(w["obs_seq"], rw["obs_seq"], rw["obs_seq"][written]),
                    compare.max_gap(w["rewards"], rw["rewards"]),
                    compare.max_gap(w["actions"], rw["actions"]))
    moved_p, moved_r = [], []
    for net in ("policy", "critic"):
        for a, p, r in zip(pre["sac"][net], post["sac"][net], ref["sac"][net]):
            moved_p.append(p - a)
            moved_r.append(r - a)
    return {"env_gap": env_gap, "world_gap": world_gap,
            "sac_change_gap": compare.leaf_gap(moved_p, moved_r)}
