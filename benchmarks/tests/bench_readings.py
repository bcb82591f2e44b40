"""Readings for the limits: for each seed, one run of a cell at its own size
with a short window, the numbers it compares for the program, and the same
numbers for each stand-in (``harness/stand_in.py``) put in the program's
place on that run's state.  Runs on the card:

    python3 benchmarks/tests/bench_readings.py --workload ks_autoreg-h7 \\
        --seconds 3 --seeds 11 12 13 > readings.jsonl

One JSON line per seed: ``program``, ``stand_ins`` (name -> numbers) and
``correct`` by the cell's limits for each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmarks.harness.cell import Cell, load_module  # noqa: E402
from benchmarks.harness.compare import judge  # noqa: E402
from benchmarks.harness.stand_in import NAMES  # noqa: E402


POLICY = [f"policy.{n}.{p}" for n in ("linear1", "linear2", "mean", "log_std")
          for p in ("weight", "bias")]
CRITIC = [f"critic.linear{i}.{p}" for i in range(1, 7) for p in ("weight", "bias")]


def look(inputs, worst: int = 4):
    """The leaves that read the widest gaps of the change, with their gap
    and the reference's norm: where a number's value comes from."""
    import torch

    from benchmarks.reference.surrogate import layout

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    rows = []
    if "pre" in inputs:  # the fused iteration's SAC leaves
        pre, post, ref = inputs["pre"]["sac"], inputs["post"]["sac"], inputs["ref"]["sac"]
        names = POLICY + CRITIC
        pairs = [(p - a, r - a) for net in ("policy", "critic")
                 for a, p, r in zip(pre[net], post[net], ref[net])]
    else:  # the fit's members' leaves after the one-step calls
        p0 = inputs["start"]["fit"]["params"]
        dp = inputs["calls"][-2]["fit"]["params"].to(p0.device) - p0
        dr = inputs["ref"][-2]["params"] - p0
        names, pairs, off = [], [], 0
        for name, shape in layout(inputs["cfg"]["n"]):
            size = int(torch.tensor(shape).prod())
            for m in range(p0.shape[0]):
                names.append(f"{m}:{name}")
                pairs.append((dp[m, off: off + size], dr[m, off: off + size]))
            off += size
    norms = [norm(r) for _, r in pairs]
    med = sorted(norms)[len(norms) // 2]
    for name, (p, r), rn in zip(names, pairs, norms):
        rows.append([name, abs(norm(p) - rn) / max(rn, med), rn, r.numel()])
    rows.sort(key=lambda x: -x[1])
    gaps = sorted(x[1] for x in rows)
    return {"worst": rows[:worst], "median_leaf_gap": gaps[len(gaps) // 2], "median_norm": med}


def readings(cell, stand_ins=NAMES):
    driver = load_module(ROOT / "benchmarks" / "drivers" / f"{cell.traffic['driver']}.py")
    out = driver.run(cell, time.perf_counter())
    line = {"seed": cell.seed, "program": out["values"],
            "correct": judge(out["values"], cell.limits)[0], "look": look(out["inputs"]),
            "stand_ins": {}}
    for name in stand_ins:
        values = driver.check(out["inputs"], name)
        line["stand_ins"][name] = {"values": values, "correct": judge(values, cell.limits)[0]}
        if name == "control" and "pre" in out["inputs"]:
            line["stand_ins"][name]["look"] = look(
                dict(out["inputs"], post=_stand_in_post(driver, out["inputs"], name)))
    return line


def _stand_in_post(driver, inputs, name):
    from benchmarks.harness.stand_in import planted
    import torch

    with planted(name):
        gen = torch.Generator(device=inputs["device"])
        gen.set_state(inputs["gen"])
        it = driver.mbpo.Iteration(inputs["cfg"], inputs["device"])
        return it.iterate(driver.reference_state(inputs["pre"], inputs["refit"],
                                                 inputs["cfg"]["delta"]), gen)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        cell = Cell.load(args.workload, seed, args.seconds, False)
        cell.device = torch.device("cuda", 0)
        print(json.dumps(readings(cell)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
