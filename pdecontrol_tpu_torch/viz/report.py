"""Run report generator: learning curves + summary from a metrics.jsonl.

    python -m pdecontrol_tpu_torch.viz.report --run_dir runs/ks50k --out results/ks50k

A copy of ``pdecontrol_tpu.viz.report`` (numpy, matplotlib and json only),
kept in the port so that importing it never runs the JAX package's
``__init__``; both packages write the same ``metrics.jsonl`` records.  The
port's copy also reads a ``metrics.jsonl.gz`` (the layout of ``results/``),
and imports matplotlib only to render, so that ``summary`` runs on a host
without it (``viz/long_run.py``).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys

import numpy as np


def load(run_dir: str):
    """The records of ``metrics.jsonl``, or of ``metrics.jsonl.gz`` where
    only that is kept (``results/``)."""
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        with gzip.open(path + ".gz", "rt") as f:
            return [json.loads(l) for l in f]
    return [json.loads(l) for l in open(path)]


def series(recs, key, x_key="num_steps_sampled"):
    xs, ys = [], []
    for r in recs:
        if key in r and r[key] is not None and x_key in r:
            xs.append(r[x_key])
            ys.append(r[key])
    return np.asarray(xs), np.asarray(ys)


def summary(recs) -> dict:
    _, ev = series(recs, "eval_return_mean")
    return {
        "iterations": recs[-1].get("iteration"),
        "env_steps": recs[-1].get("num_steps_sampled"),
        "wall_time_s": recs[-1].get("time"),
        "eval_return_first": float(ev[0]) if len(ev) else None,
        "eval_return_best": float(np.max(ev)) if len(ev) else None,
        "eval_return_last": float(ev[-1]) if len(ev) else None,
    }


def render(run_dir: str, out: str) -> dict:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    recs = load(run_dir)
    os.makedirs(out, exist_ok=True)

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))

    x, y = series(recs, "eval_return_mean")
    axes[0, 0].plot(x, y, marker="o", ms=3)
    axes[0, 0].set_title("Deterministic eval episode return")
    axes[0, 0].set_xlabel("env steps sampled")

    x, y = series(recs, "collect_reward_mean")
    if len(x):
        axes[0, 1].plot(x, y, lw=0.6, alpha=0.5)
        if len(y) > 20:
            k = max(len(y) // 50, 1)
            smooth = np.convolve(y, np.ones(k) / k, mode="valid")
            axes[0, 1].plot(x[k - 1 :], smooth, lw=1.5)
    axes[0, 1].set_title("Collect per-step reward")
    axes[0, 1].set_xlabel("env steps sampled")

    x, y = series(recs, "val_loss")
    axes[1, 0].plot(x, y, marker="o", ms=3)
    axes[1, 0].set_yscale("log")
    axes[1, 0].set_title("Surrogate val loss (unscaled free-run MSE)")
    axes[1, 0].set_xlabel("env steps sampled")

    x, y = series(recs, "sac_qf_loss")
    if len(x):
        axes[1, 1].plot(x, y, lw=0.6)
        axes[1, 1].set_yscale("log")
    axes[1, 1].set_title("SAC critic loss")
    axes[1, 1].set_xlabel("env steps sampled")

    fig.tight_layout()
    fig.savefig(os.path.join(out, "learning_curves.png"), dpi=120)
    plt.close(fig)

    result = summary(recs)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    print(json.dumps(render(args.run_dir, args.out), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
