"""The numbers of a long MBPO run, read from what it left behind:

    python -m pdecontrol_tpu_torch.viz.long_run --run_dir results/torch_ks50k \\
        [--log runs/torch_ks50k.log]

reads ``metrics.jsonl`` (or ``metrics.jsonl.gz``) of ``--run_dir`` and
prints one JSON object:

  * ``summary``: ``viz/report.py``'s (first, best and last eval return, wall
    time, env steps), and whether the best eval return lies in the band of
    the JAX package's flagship 50k runs (``JAX_BAND``);
  * ``eval_at``: the eval return at every 10,000 env steps sampled (the
    evaluation at or just before each);
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

It needs no matplotlib (``viz/report.py`` imports it only to render).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, List, Optional

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


def report(run_dir: str, log: Optional[str] = None) -> Dict:
    recs = load(run_dir)
    out = {"summary": summary(recs), "eval_at": eval_at(recs), "horizons": horizons(recs),
           "retrains": retrains(recs), "captures": captures(recs)}
    if log:
        out.update(from_log(log))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--log", default=None, help="the run's standard output")
    args = p.parse_args(argv)
    print(json.dumps(report(args.run_dir, args.log), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
