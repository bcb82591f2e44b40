"""Wall-time waterfall over a run's metrics.jsonl: attribute EVERY second.

Per-iteration wall time is taken from the committed ``time`` field deltas
(which sum to the run's total by construction), bucketed into warmup /
steady / retrain / eval iterations, and the retrain bucket is broken down
into its logged sub-fields (t_delta, t_split, the fit's timers, t_post,
t_gc) with the residual printed, never silently dropped.  The fit's timers
are those of its route, as in the JAX package's stream: ``t_fit_prep``,
``t_fit_dispatch`` and ``t_fit_ready`` (the lock-step fit, by default) or
``t_fit_val`` (``--no_fuse_fit``), and ``t_fit_train`` and ``t_fit_val``
(``--sequential_member_training``, summed over the members).  The fused
iterations' fields are summed beside the buckets: ``t_dispatch`` (host time
to launch the iteration), ``t_ready`` (dispatch to the record's late pull,
which spans the next dispatch and so bounds the device time from above),
``t_fused`` (an evaluation iteration's dispatch and pull), ``t_capture``
(the CUDA graph captures) and ``t_fit_capture`` (the fit's captures, which
its ``t_fit_dispatch`` holds), as the JAX package's stream carries the
first three.

Usage: ``python -m pdecontrol_tpu_torch.utils.waterfall runs/ks50k/metrics.jsonl``

A copy of ``pdecontrol_tpu.utils.waterfall`` (plain Python) with the port's
fields.  A resumed run's ``time`` restarts at the resume, so analyse the
stretches before and after it separately.

Reference contrast: the reference logs wall-clock only (mbrl.py:385,624).
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Dict, List


PHASE_FIELDS = [
    "t_collect", "t_surrogate", "t_imagine", "t_policy", "t_pull", "t_eval",
]
FUSED_FIELDS = ["t_dispatch", "t_ready", "t_fused", "t_capture", "t_fit_capture"]
# Sub-fields of t_surrogate; t_gc overlaps (GC pauses inside the others)
# and is reported separately, not summed.
FIT_FIELDS = ["t_fit_prep", "t_fit_dispatch", "t_fit_ready", "t_fit_train", "t_fit_val"]
RETRAIN_FIELDS = ["t_delta", "t_split", *FIT_FIELDS, "t_post"]


def analyze(path: str) -> Dict:
    records: List[Dict] = [json.loads(line) for line in open(path)]
    iters = [r for r in records if "iteration" in r and "time" in r]
    if not iters:
        raise SystemExit("no committed iteration records found")

    warmup = 0.0
    for r in records:
        if "t_warmup_collect" in r:
            warmup = r.get("t_warmup_collect", 0.0) + r.get(
                "t_warmup_eval", 0.0)
            break

    buckets = defaultdict(float)
    counts = defaultdict(int)
    phases = defaultdict(float)
    sur_sub = defaultdict(float)
    fused = defaultdict(float)
    sur_fit_total = 0.0
    gc_total = 0.0
    prev_t = 0.0
    for r in iters:
        dt = r["time"] - prev_t
        prev_t = r["time"]
        for f in FUSED_FIELDS:
            fused[f] += r.get(f, 0.0)
        if "t_surrogate" in r:
            kind = "retrain"
            for f in PHASE_FIELDS:
                phases[f] += r.get(f, 0.0)
            for f in RETRAIN_FIELDS:
                sur_sub[f] += r.get(f, 0.0)
            sur_fit_total += r.get("t_fit_total", 0.0)
            gc_total += r.get("t_gc", 0.0)
        elif "t_eval" in r:
            kind = "eval"
        else:
            kind = "steady"
        if r.get("t_warmup_collect"):
            dt -= warmup  # iteration 0's delta includes the warmup block
            buckets["warmup"] += warmup
            counts["warmup"] += 1
        buckets[kind] += dt
        counts[kind] += 1

    total = iters[-1]["time"]
    fit_accounted = sum(sur_sub[f] for f in FIT_FIELDS)
    out = {
        "total_s": round(total, 1),
        "warmup_s": round(buckets["warmup"], 1),
        "steady": {"n": counts["steady"],
                   "sum_s": round(buckets["steady"], 1),
                   "mean_ms": round(1e3 * buckets["steady"]
                                    / max(counts["steady"], 1), 1)},
        "retrain": {
            "n": counts["retrain"],
            "sum_s": round(buckets["retrain"], 1),
            "phases": {k: round(v, 1) for k, v in phases.items() if v},
            # dt beyond the phase timers (dispatch pipelining, host glue).
            "phase_residual_s": round(
                buckets["retrain"] - sum(phases.values()), 1),
            "surrogate_sub": {k: round(v, 1) for k, v in sur_sub.items()
                              if v},
            "t_fit_total_s": round(sur_fit_total, 1),
            "gc_overlap_s": round(gc_total, 1),
            # t_surrogate beyond its own sub-fields (the fit call's Python
            # glue, which t_fit_total covers).
            "surrogate_residual_s": round(
                phases["t_surrogate"] - sum(sur_sub.values()), 1),
            # within the fit call but outside the train/val timers: the
            # host early-stopping bookkeeping.
            "fit_internal_residual_s": round(
                sur_fit_total - fit_accounted, 1) if sur_fit_total else None,
        },
        "eval": {"n": counts["eval"], "sum_s": round(buckets["eval"], 1),
                 "t_eval_s": round(phases["t_eval"], 1)},
        "fused_s": {k: round(v, 1) for k, v in fused.items() if v},
        "residual_s": round(total - sum(
            buckets[k] for k in ("warmup", "steady", "retrain", "eval")
        ), 1),
    }
    return out


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "metrics.jsonl"
    out = analyze(path)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
