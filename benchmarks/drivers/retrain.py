"""Window driver: later surrogate retrains, back to back, as the loop runs
them at a retrain iteration (``update_delta_transform``, then
``update_surrogates`` into ``SurrogateTrainer.fit_ensemble``: every member
in lock-step, on the card each TBPTT step and each validation step a
replayed CUDA graph, one pull of the val losses per epoch).

Traffic keys: ``replay_transitions`` (the replay is filled with that many
transitions of the random warmup through the env), ``iteration`` (the
loop's iteration number at those transitions, which seeds the split),
``check_calls`` (one-step calls of the same retrain that set-up makes and
the reference follows), ``settle_s`` (after set-up the run goes on
retraining for that long before the window opens: for up to ~25 s after
the calls that capture the fit's graphs the card runs the same retrain ~9%
slower, measured on the H100 with its clocks unchanged, and gone when the
capture's release of the allocator's cached memory is skipped),
``traced_epochs`` (a traced run traces one retrain of that many epochs
after the window).

Set-up: the controller from the seed, the replay filled, every member's
starting weights drawn by the benchmark from the seed
(``harness/weights.py``), then ``check_calls`` calls of
``update_surrogates`` with the configuration's later-retrain settings but a
budget of one step each, and one of one epoch: they capture the step's and
the validation step's graphs and are the first steps of the fit that the
window goes on with.  ``setup_s`` ends there; the settle follows, its
seconds printed apart.  The window closes at the end of the last retrain
begun in it.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmarks.harness import compare, report, snapshot, weights
from benchmarks.harness.cell import env_config
from benchmarks.harness.stand_in import planted
from benchmarks.harness.tracing import TracedSpan
from benchmarks.reference import fit as F
from benchmarks.reference import mbpo, ks
from benchmarks.reference.surrogate import FAMILIES, layout


def check_budgets(ctl, tc, one_step_calls: int) -> List[int]:
    """The set-up's calls of the retrain: ``one_step_calls`` of one step
    each, whose gradient and changes the reference follows, then one of an
    epoch, whose validation losses the loop keeps (a call whose budget ends
    inside an epoch stops before it keeps them)."""
    fill = ctl.replay.fill.cpu().numpy()
    length = tc.tau + int(ctl.curriculum(iteration=ctl.iteration, epoch=0, step=0))
    train_np, _ = F.split(fill, ctl.iteration, ctl.config.val_split_ratio, length)
    return [1] * one_step_calls + [F.epoch_steps(fill, train_np, length, tc.batch_size)]


def run(cell, t_process: float) -> Dict:
    tr = cell.traffic
    ctl = cell.controller()
    cfg = ctl.config
    cuda = ctl.device.type == "cuda"

    # ---- set-up: the replay, the benchmark's weights, then the fit's first
    # steps through its own call
    ctl.collect(max(int(tr["replay_transitions"]) // cfg.num_envs, 1), random=True)
    ctl.iteration = int(tr["iteration"])
    tc = ctl.train_cfgs["iterations"]
    w = weights.surrogate(ctl.env.n, cfg.num_dynamics_models, cell.seed, ctl.device)
    with torch.no_grad():
        ctl.ensemble.params.copy_(w)
    w = w.cpu()
    start = snapshot.copy({"replay": snapshot.replay(ctl.replay), "u": ctl.env_state.u})
    start["fit"] = {"params": w, "exp_avg": torch.zeros_like(w), "exp_avg_sq": torch.zeros_like(w),
                    "count": torch.zeros(w.shape[0], dtype=torch.int32)}
    gen_state = ctl.gen.get_state()
    budgets = check_budgets(ctl, tc, int(tr["check_calls"]))
    calls: List[Dict] = []
    try:
        for budget in budgets:
            ctl.train_cfgs["iterations"] = tc._replace(min_steps=0, max_steps=budget)
            ctl.update_delta_transform()
            logs = ctl.update_surrogates()
            calls.append({"steps": budget, "loss": logs["train_loss"],
                          "val": list(logs["elite_scores"]),
                          "fit": snapshot.copy(snapshot.fit(ctl.fit_state)),
                          "t_fit_capture": logs.get("t_fit_capture", 0.0)})
    finally:
        ctl.train_cfgs["iterations"] = tc
    ctl._sync()
    setup_s = time.perf_counter() - t_process
    t_settle = time.perf_counter()
    while time.perf_counter() - t_settle < float(tr["settle_s"]):
        ctl.update_delta_transform()
        ctl.update_surrogates()
    ctl._sync()
    settle_s = time.perf_counter() - t_settle

    # ---- window
    retrains: List[Dict] = []
    t0 = time.perf_counter()
    while not retrains or time.perf_counter() - t0 < cell.seconds:
        ctl.update_delta_transform()
        logs = ctl.update_surrogates()
        retrains.append({k: logs[k] for k in ("steps", "epochs", "t_fit_dispatch", "t_fit_total")})
    ctl._sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(ctl.device) if cuda else 0
    steps = sum(r["steps"] for r in retrains)
    print(f"[bench] set-up {setup_s:.3f} s, then settled {settle_s:.3f} s; retrains (steps, "
          "epochs, s): " + ", ".join(f"({r['steps']}, {r['epochs']}, {r['t_fit_total']})"
                                      for r in retrains) + f"; window {window_s:.3f} s",
          file=sys.stderr)
    out = {"setup_s": setup_s, "attempted": len(retrains), "failed": 0,
           "memory_peak_bytes": peak, "e2e": {"fit_steps_per_s": steps / window_s}}
    if cell.trace:
        epoch = check_budgets(ctl, tc, 0)[0]
        ctl.train_cfgs["iterations"] = tc._replace(
            min_steps=0, max_steps=int(tr["traced_epochs"]) * epoch)
        span = TracedSpan()
        span.start()
        try:
            ctl.update_delta_transform()
            logs = ctl.update_surrogates()
        finally:
            span.stop()
            ctl.train_cfgs["iterations"] = tc
        out["trace"] = span.summary()
        out["per_layer"] = report.read_layers(cell, {
            "ctl": ctl, "traffic": tr, "setup": calls, "window": retrains,
            "trace": out["trace"], "traced": [logs]})

    # ---- the comparison, once the program's state is freed
    ref_cfg = {"n": ctl.env.n, "length": tc.tau + int(ctl.curriculum(
                   iteration=ctl.iteration, epoch=0, step=0)),
               "batch_size": tc.batch_size, "mode": FAMILIES[cfg.factory],
               "delta": ctl.env.delta, "tau": tc.tau, "tbtt": tc.tbtt, "lr": tc.lr,
               "val_split_ratio": cfg.val_split_ratio, "iteration": ctl.iteration,
               "env": env_config(ctl.env)}
    device = ctl.device
    del ctl
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["inputs"] = {"start": snapshot.to(start, device), "gen": gen_state, "calls": calls,
                     "cfg": ref_cfg, "device": device, "seed": cell.seed}
    out["values"] = check(out["inputs"])
    return out


def follow(start: Dict, gen_state, ref_cfg: Dict, device, budgets: List[int]) -> List[Dict]:
    """The reference's retrain calls from the program's state at their
    start: the split, the delta refit, and each call's steps and its
    validation step, on the same draws."""
    rp = start["replay"]
    vmin, vmax = mbpo.obs_scaling(rp, start["u"])
    d_mean, d_std = mbpo.delta_scaling(rp, vmin, vmax, ref_cfg["delta"])
    it = mbpo.Iteration({"env": ref_cfg["env"]}, device)
    st = dict(start["fit"], vmin=vmin, vmax=vmax, d_mean=d_mean, d_std=d_std)
    fill = rp["fill"].cpu().numpy()
    train_np, val_np = F.split(fill, ref_cfg["iteration"], ref_cfg["val_split_ratio"],
                               ref_cfg["length"])
    masks = [torch.as_tensor(x, device=device) for x in (train_np, val_np)]
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    out = []
    for steps in budgets:
        r = F.lockstep_call(st, rp, masks[0], masks[1], gen, ref_cfg, it.world_action, steps)
        r["params"] = st["params"].clone()
        r["exp_avg"] = st["exp_avg"].clone()
        out.append(r)
    return out


def _leaves(flat: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Each member's parameters, leaf by leaf."""
    out, offset = [], 0
    for _, shape in layout(n):
        size = int(np.prod(shape))
        out.extend(flat[:, offset: offset + size].unbind(0))
        offset += size
    return out


def check(inputs: Dict, stand_in: Optional[str] = None) -> Dict[str, float]:
    """``loss_gap``: each call's last train loss (the members' mean);
    ``grad_gap``: the first gradient as the optimizer got it, from its first
    moment after one step, by the worst leaf; ``change_median_gap``: the
    parameters' change over the one-step calls, by the median leaf among
    those the reference's first gradient moves (a small leaf's change under
    Adam turns on the sign of its smallest gradients, so the worst leaf's
    swings with rounding from seed to seed); ``val_gap``: every member's
    val loss at the end of the epoch call; ``env_gap``: a sample of the
    replay's transitions, drawn from the seed, against the plain env step
    (the warmup that filled it).
    With ``stand_in`` (``harness/stand_in.py``) the stand-in's calls take
    the program's place."""
    start, calls, ref_cfg, device = (inputs[k] for k in ("start", "calls", "cfg", "device"))
    if "ref" not in inputs:
        inputs["ref"] = follow(start, inputs["gen"], ref_cfg, device, [c["steps"] for c in calls])
    ref = inputs["ref"]
    if stand_in is not None:
        with planted(stand_in):
            calls = [{"loss": float(r["loss"].mean()), "val": r["val"].tolist(),
                      "fit": {"params": r["params"], "exp_avg": r["exp_avg"]}}
                     for r in follow(start, inputs["gen"], ref_cfg, device, [c["steps"] for c in calls])]
    n = ref_cfg["n"]
    loss_gap = max(abs(c["loss"] - float(r["loss"].mean())) / abs(float(r["loss"].mean()))
                   for c, r in zip(calls, ref))
    val_gap = max(abs(a - float(b)) / abs(float(b))
                  for a, b in zip(calls[-1]["val"], ref[-1]["val"]))
    g_prog = _leaves(calls[0]["fit"]["exp_avg"].to(device) / (1 - F.B1), n)
    g_ref = _leaves(ref[0]["grad"], n)
    p0 = start["fit"]["params"]
    keep = compare.moving_leaves(g_ref)
    change = compare.median_leaf_gap(_leaves(calls[-2]["fit"]["params"].to(device) - p0, n),
                                     _leaves(ref[-2]["params"] - p0, n), keep)
    return {"loss_gap": loss_gap, "grad_gap": compare.leaf_gap(g_prog, g_ref),
            "change_median_gap": change, "val_gap": val_gap,
            "env_gap": replay_gap(start, ref_cfg, device, inputs["seed"], stand_in)}


def replay_gap(start: Dict, ref_cfg: Dict, device, seed: int, stand_in: Optional[str] = None,
               sample: int = 64) -> float:
    """The worst gap of the next frame and the reward of ``sample``
    transitions of the replay, drawn from the seed, from the plain env
    step on the stored frame and action (a stand-in's step in place of the
    stored ones, if given)."""
    rp = start["replay"]
    fill = rp["fill"].cpu().numpy()
    rows, cols = np.nonzero(np.arange(rp["actions"].shape[1])[None, :] < fill[:, None])
    pick = np.random.default_rng(seed).choice(len(rows), size=min(sample, len(rows)),
                                              replace=False)
    r = torch.as_tensor(rows[pick], device=device)
    c = torch.as_tensor(cols[pick], device=device)
    u = rp["obs_seq"][r, c][:, 0]
    it = mbpo.Iteration({"env": ref_cfg["env"]}, device)
    phi = it.field(rp["actions"][r, c])[:, 0]
    env = ref_cfg["env"]
    u1, rew = ks.control_period(u.double(), phi.double(), env["length"], env["dt"],
                                env["cfg_steps"], ks.objective_of(env))
    nxt, stored = rp["obs_seq"][r, c + 1][:, 0], rp["rewards"][r, c]
    if stand_in is not None:
        with planted(stand_in):
            nxt, stored = it.period(u, phi)
    return max(compare.max_gap(nxt, u1), compare.max_gap(stored, rew))
