"""The result line of a run: ``correct``, ``attempted``, ``failed``, the
cell's metrics (end-to-end with ``--trace 0``, per-layer with ``--trace
1``), ``device``, the trace's ``breakdown``, and last the numbers compared
beside their limits."""

from __future__ import annotations

import sys
from typing import Dict

from benchmarks.harness.cell import BENCH, ROOT, load_json, load_module
from benchmarks.harness.compare import judge


def applies(metric: Dict, cell) -> bool:
    return "workloads" not in metric or cell.name in metric["workloads"]


def read_layers(cell, ctx: Dict) -> Dict[str, float]:
    """The cell's per-layer metrics, each read by ``metrics/<name>.py`` from
    what the traced run hands every reader: ``ctl`` (the live controller),
    ``traffic``, ``setup`` and ``window`` (the records of set-up and of the
    window's untraced part), ``walls`` (seconds between the untraced
    iterations), ``trace`` (``TracedSpan.summary``) and ``traced`` (the
    records of the traced work).  A reader that finds nothing returns
    None, and the metric is left out."""
    values = {}
    for m in load_json(ROOT / "BENCHMARK.json")["per_layer"]:
        if applies(m, cell):
            value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                values[m["name"]] = value
    return values


def result(cell, out: Dict, device: Dict) -> Dict:
    bench = load_json(ROOT / "BENCHMARK.json")
    if not cell.trace:
        metrics = {m["name"]: {"value": out["setup_s"] if m["name"] == "setup_s"
                               else out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, cell)}
    else:
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        metrics = {name: {"value": v, "unit": units[name]}
                   for name, v in out.get("per_layer", {}).items()}
    correct, checks = judge(out["values"], cell.limits)
    device = dict(device, memory_peak_bytes=int(out["memory_peak_bytes"]))
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if cell.trace and out.get("trace"):
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = checks
    return line


def print_checks(checks: Dict[str, Dict]) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
