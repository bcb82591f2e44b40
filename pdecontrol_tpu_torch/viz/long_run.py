"""The numbers of a long MBPO run, read from what it left behind:

    python -m pdecontrol_tpu_torch.viz.long_run --run_dir results/torch_ks50k \\
        [--log runs/torch_ks50k.log] [--every 10000]

reads ``metrics.jsonl`` (or ``metrics.jsonl.gz``) of ``--run_dir`` and
prints one JSON object:

  * ``summary``: ``viz/report.py``'s (first, best and last eval return, wall
    time, env steps), and whether the best eval return lies in the band of
    the JAX package's flagship 50k runs (``JAX_BAND``);
  * ``eval_at``: the eval return at every 10,000 env steps sampled, or
    every ``--every`` (5,000 for a Burgers run; the evaluation at or just
    before each);
  * ``horizons``: per horizon, the count of non-retrain, non-evaluation
    iterations and the median, least and largest of their dispatch to pull
    (``t_dispatch + t_ready``, seconds; ``t_ready`` spans the next
    iteration's dispatch, so this bounds an iteration's device time from
    above; an iteration that captured its graph is counted apart,
    ``captured``, and one followed by a capture is left out), and of their
    wall time (``wall``: the gap between its
    record's ``time``, taken after its dispatch, and the next one's, where
    the next iteration is pipelined too);
  * ``retrains``: the first retrain's and the median of the later ones'
    ``t_fit_total``, ``epochs``, ``steps`` and ``t_surrogate``;
  * ``captures``: the iterations whose records carry a capture, with its
    ``t_capture`` and ``graph_pool_mb``;
  * from ``--log``, the run's standard output: the ``[memory]`` lines by
    iteration and the ``[rank]`` line (its graphs by key with their
    replays, K1's launches, the replays' ring positions, peak memory).

Without ``--run_dir`` it compares the study's runs in ``results/``, port
beside JAX, and prints one JSON object (``compare``):

  * per reward channel, each MBPO run's eval return at 10k ... 50k env
    steps and its best, and each SAC stream's first env step whose eval
    return reaches the MBPO runs' best (the median of the port's runs'
    bests; JAX's ``ks50k`` and ``ks50k_dissipation``, as ``results/
    RESULTS.md`` sections 2 and 8 take them; where the port has no 50k
    MBPO run on a channel, JAX's), with that step's ratio to 50,000, its
    evaluations to 50k and its first record's qf loss; beside them the
    JAX package's SAC baseline run on the CPU (``JAX_CPU_SAC``);
  * the bf16_3x, dissipation, latent and Burgers runs beside their JAX
    runs, each at its marks, and, for a run that reached its full length,
    whether its best lies under its limit (``PAIRS``);
  * the lag test: the port's flagship seeds against the JAX flagship runs
    (``jax_flagship_runs``), each run's mean eval return over the 10k ...
    50k marks, the one-sided exact permutation p of the port's mean
    (``permutation_p``) and the verdict, fixed before the runs were read:
    confirmed at p <= 0.05, cleared at p > 0.2, open between.

It needs no matplotlib (``viz/report.py`` imports it only to render).
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import re
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from pdecontrol_tpu_torch.viz.report import load
from pdecontrol_tpu_torch.viz.report import summary as report_summary

# Best eval returns of the JAX package's flagship 50k runs
# (``results/ks50k*/summary.json``, ``eval_return_best``): r2 -166.3 ...
# r3f and r3g -148.8.
JAX_BAND = (-166.3, -148.8)
EVAL_EVERY = 10_000


def summary(recs: List[Dict]) -> Dict:
    """``viz/report.py``'s summary, and whether its best lies in the band."""
    out = report_summary(recs)
    best = out["eval_return_best"]
    return {**out, "jax_band": list(JAX_BAND),
            "in_band": best is not None and JAX_BAND[0] <= best <= JAX_BAND[1]}


def eval_at(recs: List[Dict], every: int = EVAL_EVERY) -> Dict[int, float]:
    """The eval return at or just before every ``every`` env steps."""
    evals = [(r["num_steps_sampled"], r["eval_return_mean"]) for r in recs
             if r.get("eval_return_mean") is not None and "num_steps_sampled" in r]
    out = {}
    if not evals:
        return out
    for mark in range(every, evals[-1][0] + every, every):
        seen = [v for s, v in evals if s <= mark]
        if seen:
            out[mark] = seen[-1]
    return out


def _stats(xs: List[float]) -> Dict:
    if not xs:
        return {"count": 0, "median": None, "min": None, "max": None}
    return {"count": len(xs), "median": round(float(np.median(xs)), 4),
            "min": round(float(np.min(xs)), 4), "max": round(float(np.max(xs)), 4)}


def horizons(recs: List[Dict]) -> Dict[int, Dict]:
    """Dispatch to pull and wall time of the pipelined iterations, per
    horizon."""
    its = [r for r in recs if "iteration" in r]
    pulls: Dict[int, List[float]] = {}
    walls: Dict[int, List[float]] = {}
    captured: Dict[int, List[float]] = {}
    for r, nxt in zip(its, its[1:] + [None]):
        if "t_dispatch" not in r or "t_ready" not in r:
            continue
        pull = round(r["t_dispatch"] + r["t_ready"], 4)
        if "t_capture" in r:
            captured.setdefault(r["horizon"], []).append(pull)
            continue
        if nxt is not None and "t_capture" in nxt and "t_dispatch" in nxt:
            continue  # its t_ready spans the next iteration's capture
        pulls.setdefault(r["horizon"], []).append(pull)
        if (nxt is not None and nxt["iteration"] == r["iteration"] + 1
                and "t_dispatch" in nxt and "t_capture" not in nxt):
            walls.setdefault(r["horizon"], []).append(nxt["time"] - r["time"])
    return {h: {**_stats(pulls.get(h, [])), "wall": _stats(walls.get(h, [])),
                "captured": captured.get(h, [])}
            for h in sorted(pulls.keys() | captured.keys())}


def retrains(recs: List[Dict]) -> Dict:
    fits = [r for r in recs if "t_fit_total" in r]
    keys = ("t_fit_total", "epochs", "steps", "t_surrogate")
    out: Dict = {"count": len(fits)}
    if fits:
        out["first"] = {"iteration": fits[0].get("iteration"),
                        **{k: fits[0].get(k) for k in keys}}
    if len(fits) > 1:
        out["later_median"] = {k: float(np.median([r[k] for r in fits[1:] if k in r]))
                               for k in keys}
        out["later_range"] = {k: [min(r[k] for r in fits[1:] if k in r),
                                  max(r[k] for r in fits[1:] if k in r)] for k in keys}
    return out


def captures(recs: List[Dict]) -> List[Dict]:
    return [{"iteration": r["iteration"], "t_capture": r["t_capture"],
             "graph_pool_mb": r.get("graph_pool_mb", 0.0)}
            for r in recs if "t_capture" in r and "iteration" in r]


MEMORY = re.compile(r"^\[memory\] iteration (\d+): peak allocated ([\d.]+) MB, "
                    r"reserved ([\d.]+) MB")


def from_log(path: str) -> Dict:
    """The ``[memory]`` lines and the ``[rank]`` line of a run's output."""
    memory, rank = {}, None
    with open(path) as f:
        for line in f:
            m = MEMORY.match(line)
            if m:
                memory[int(m.group(1))] = {"peak_allocated_mb": float(m.group(2)),
                                           "reserved_mb": float(m.group(3))}
            elif line.startswith("[rank] "):
                rank = json.loads(line[len("[rank] "):])
    return {"memory": memory, "rank": rank}


def report(run_dir: str, log: Optional[str] = None, every: int = EVAL_EVERY) -> Dict:
    recs = load(run_dir)
    out = {"summary": summary(recs), "eval_at": eval_at(recs, every), "horizons": horizons(recs),
           "retrains": retrains(recs), "captures": captures(recs)}
    if log:
        out.update(from_log(log))
    return out


RESULTS = "results"
MARKS = tuple(range(EVAL_EVERY, 50_000 + 1, EVAL_EVERY))
# The port's runs by reward channel: MBPO at 50k env steps (the flagship's
# seeds 0-3; runscripts/mbpo_ks_dissipation.sh's run) and the SAC baseline
# at 500k.
PORT_MBPO = {"l2control": ("torch_ks50k", "torch_ks50k_seed1", "torch_ks50k_seed2",
                           "torch_ks50k_seed3"),
             "dissipation": ("torch_ks50k_dissipation",)}
PORT_SAC = {"l2control": ("torch_sac500k", "torch_sac500k_seed1"),
            "dissipation": ("torch_sac500k_dissipation", "torch_sac500k_dissipation_seed1")}
# The JAX pair of each channel (results/RESULTS.md sections 2 and 8).
JAX_MBPO = {"l2control": ("ks50k",), "dissipation": ("ks50k_dissipation",)}
JAX_SAC = {"l2control": ("sac500k",), "dissipation": ("sac500k_dissipation",)}
# The JAX package's SAC baseline run on the CPU with results/sac500k's
# cadence (``python -m pdecontrol_tpu.sac.train --platform cpu
# --learning_starts 5000 --eval_freq 10000``), seeds 0 and 1, to 57k steps.
JAX_CPU_SAC = {"l2control": ("jax_cpu_sac57k_seed0", "jax_cpu_sac57k_seed1"),
               "dissipation": ()}


class Pair(NamedTuple):
    """A port run's JAX run, the limit of "well outside" for its best at
    full length, the env steps of that length and the spacing of its
    marks."""
    jax: str
    limit: float
    steps: int = 50_000
    every: int = EVAL_EVERY


# The port's runs of the other configurations, their JAX runs, and the
# limit of "well outside" for a best at full length, each fixed before the
# run's output was read: bf16_3x under the flagship band's low end less its
# width; the others under their JAX run's best less 11% (dissipation
# -207.24, latent_r4 -359.37, Burgers' worst JAX best, burgers20k_r3's
# -0.2020; results/burgers20k, the best, has no metrics stream).  Burgers'
# runscript stops at 20,000 env steps and evaluates every 500: its marks
# fall every 5,000.
PAIRS = {"torch_ks10k_bf16": Pair("ks50k_bf16", -181.0),
         "torch_ks10k_dissipation": Pair("ks50k_dissipation", -230.0),
         "torch_ks50k_dissipation": Pair("ks50k_dissipation", -230.0),
         "torch_ks50k_latent_r4": Pair("ks50k_latent_r4", -398.9),
         "torch_burgers20k": Pair("burgers20k_r3", -0.2242, 20_000, 5_000)}
# results/ks50k* runs of another configuration than runscripts/mbpo_ks.sh's.
JAX_OTHER_CONFIG = {
    "ks50k_bf16": "runscripts/mbpo_ks_bf16.sh: K2 at bf16_3x",
    "ks50k_delay": "another surrogate family (KSDelayCNNSurrogateFactory)",
    "ks50k_dissipation": "the dissipation objective (runscripts/mbpo_ks_dissipation.sh)",
    "ks50k_latent": "another surrogate family (KSLatentConvolutionalLSTM)",
    "ks50k_latent_r4": "another surrogate family (runscripts/mbpo_ks_latent_r4.sh)",
}
P_CONFIRMED, P_CLEARED = 0.05, 0.2
# Env steps sampled at a full run's last record: its length less the last
# iteration's steps (10 envs).
LAST_ITERATION_STEPS = 10


def first_segment(recs: List[Dict]) -> List[Dict]:
    """The records of the run's first process: a resumed run restarts its
    clock, and its first evaluation repeats the warmup's (``ks50k_r2`` was
    resumed past 50k)."""
    for i in range(1, len(recs)):
        if recs[i].get("time", 0.0) < recs[i - 1].get("time", 0.0):
            return recs[:i]
    return recs


def _evals(recs: List[Dict]) -> List[Tuple[int, float]]:
    return [(r["num_steps_sampled"], r["eval_return_mean"]) for r in recs
            if r.get("eval_return_mean") is not None and "num_steps_sampled" in r]


def mark_mean(recs: List[Dict]) -> float:
    """The lag test's statistic: the mean eval return over the 10k ... 50k
    marks."""
    at = eval_at(recs)
    missing = [m for m in MARKS if m not in at]
    if missing:
        raise ValueError(f"no evaluation by {missing} env steps")
    return float(np.mean([at[m] for m in MARKS]))


def first_reach(recs: List[Dict], target: float) -> Optional[int]:
    """The first env step whose eval return reaches ``target``, or None."""
    return next((s for s, v in _evals(recs) if v >= target), None)


def permutation_p(port: Sequence[float], jax: Sequence[float]) -> Tuple[float, int]:
    """One-sided exact permutation p of the port group's mean: the share of
    the splits of all the runs into groups of the two sizes whose port-size
    group's mean is at most the observed one (ties count), and the number of
    splits."""
    pooled = list(port) + list(jax)
    observed = float(np.mean(port))
    means = [float(np.mean([pooled[i] for i in idx]))
             for idx in itertools.combinations(range(len(pooled)), len(port))]
    return sum(m <= observed + 1e-9 for m in means) / len(means), len(means)


def _has_stream(run_dir: str) -> bool:
    return any(os.path.exists(os.path.join(run_dir, f))
               for f in ("metrics.jsonl", "metrics.jsonl.gz"))


def jax_flagship_runs(results: str = RESULTS) -> Tuple[Dict[str, List[Dict]], Dict[str, str]]:
    """The JAX flagship runs of the lag test: every ``results/ks50k*`` run of
    ``runscripts/mbpo_ks.sh``'s configuration, its first process's records,
    one run for each distinct eval stream (reruns of one seed that timed a
    change repeat its stream); and the runs left out, with the reason.  A
    flagship run without a metrics stream raises."""
    taken: Dict[str, List[Dict]] = {}
    left_out: Dict[str, str] = {}
    streams: Dict[Tuple, str] = {}
    for run_dir in sorted(glob.glob(os.path.join(results, "ks50k*"))):
        name = os.path.basename(run_dir)
        if name in JAX_OTHER_CONFIG:
            left_out[name] = JAX_OTHER_CONFIG[name]
            continue
        if not _has_stream(run_dir):
            raise FileNotFoundError(f"{run_dir}: a flagship run without a metrics stream")
        recs = first_segment(load(run_dir))
        key = tuple(_evals(recs))
        if key in streams:
            left_out[name] = f"the same eval stream as {streams[key]}"
            continue
        streams[key] = name
        taken[name] = recs
    return taken, left_out


def _run(recs: List[Dict], marks: Sequence[int] = MARKS, every: int = EVAL_EVERY) -> Dict:
    evals = _evals(recs)
    return {"eval_at": {m: v for m, v in eval_at(recs, every).items() if m in marks},
            "best": max(v for _, v in evals), "first": evals[0][1], "last": evals[-1][1]}


def _sac(recs: List[Dict], targets: Dict[str, float], target: float) -> Dict:
    reach = first_reach(recs, target)
    evals = _evals(recs)
    return {"first_reach": reach, "ratio": None if reach is None else reach / 50_000,
            "first_reach_by_run": {k: first_reach(recs, t) for k, t in targets.items()},
            "evals_to_50k": [[s, v] for s, v in evals if s <= 50_000],
            "eval_at_50k": [v for s, v in evals if s <= 50_000][-1],
            "first_qf_loss": recs[0].get("sac_qf_loss"),
            "best": max(v for _, v in evals), "last": evals[-1][1],
            "evaluations": len(evals), "records": len(recs),
            "env_steps": recs[-1]["num_steps_sampled"]}


def _side(results: str, mbpo: Sequence[str], sac: Sequence[str],
          fallback: Optional[Dict[str, float]] = None) -> Dict:
    """MBPO runs and SAC streams of one side; without MBPO runs, the SAC
    streams are held to ``fallback``'s targets (the other side's)."""
    runs = {name: _run(first_segment(load(os.path.join(results, name)))) for name in mbpo}
    targets = {name: r["best"] for name, r in runs.items()} or dict(fallback)
    target = float(np.median(list(targets.values())))
    return {"mbpo": runs, "target": target, "targets_of": "own" if runs else "jax",
            "sac": {name: _sac(load(os.path.join(results, name)), targets, target)
                    for name in sac}}


def _pair(results: str, port: str, pair: Pair) -> Dict:
    """A port run beside its JAX run at the pair's marks; whether its best
    lies under the limit is asked of a run that reached its full length
    only."""
    marks = tuple(range(pair.every, pair.steps + 1, pair.every))
    recs = first_segment(load(os.path.join(results, port)))
    mine = {**_run(recs, marks, pair.every), "env_steps": recs[-1]["num_steps_sampled"]}
    reached = mine["env_steps"] >= pair.steps - LAST_ITERATION_STEPS
    return {"port": mine, "jax": {"run": pair.jax, **_run(first_segment(
        load(os.path.join(results, pair.jax))), marks, pair.every)}, "limit": pair.limit,
        "full_length": pair.steps, "outside": (mine["best"] < pair.limit) if reached else None}


def compare(results: str = RESULTS) -> Dict:
    """The study's comparison, port beside JAX, from ``results``."""
    out: Dict = {"channels": {}}
    for ch in PORT_MBPO:
        jax = _side(results, JAX_MBPO[ch], JAX_SAC[ch])
        fallback = {name: r["best"] for name, r in jax["mbpo"].items()}
        out["channels"][ch] = {"port": _side(results, PORT_MBPO[ch], PORT_SAC[ch], fallback),
                               "jax": jax,
                               "jax_cpu": _side(results, (), JAX_CPU_SAC[ch], fallback)}
    out["pairs"] = {port: _pair(results, port, pair) for port, pair in PAIRS.items()
                    if _has_stream(os.path.join(results, port))}
    jax_runs, left_out = jax_flagship_runs(results)
    port_means = {name: mark_mean(first_segment(load(os.path.join(results, name))))
                  for name in PORT_MBPO["l2control"]}
    jax_means = {name: mark_mean(recs) for name, recs in jax_runs.items()}
    p, splits = permutation_p(list(port_means.values()), list(jax_means.values()))
    out["lag_test"] = {
        "statistic": "mean eval return at " + ", ".join(f"{m // 1000}k" for m in MARKS),
        "port": port_means, "jax": jax_means, "jax_left_out": left_out,
        "splits": splits, "p": p,
        "verdict": "confirmed" if p <= P_CONFIRMED else "cleared" if p > P_CLEARED else "open"}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", default=None,
                   help="the run to report; without it, the study's comparison")
    p.add_argument("--log", default=None, help="the run's standard output")
    p.add_argument("--every", type=int, default=EVAL_EVERY,
                   help="the spacing of a run's marks in env steps")
    args = p.parse_args(argv)
    out = compare() if args.run_dir is None else report(args.run_dir, args.log, args.every)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
