"""The per-layer readers and the benchmark's starting weights, on the CPU: a
traced run of each driver at the tiny size hands every reader what it
reads, the idle share and the MFU leave out the profiler's own gaps, and
the weights follow from the seed alone."""

import math

import pytest
import torch

import bench_tiny
from benchmarks.harness import report, weights
from benchmarks.harness.cell import ROOT, load_json, load_module
from benchmarks.reference.surrogate import layout

# What a traced run reads on the CPU: the rest needs the card's trace or
# its phase graphs.
ON_THE_CPU = {"ks_autoreg-h7": {"iter_p90_ms.h7", "dispatch_ms.h7", "mfu.h7"},
              "ks_latent_r4-retrain": {"fit_dispatch_ms.fit", "mfu.fit"}}


@pytest.mark.parametrize("workload", sorted(ON_THE_CPU))
def test_a_traced_run_reads_its_layers(workload):
    cell = bench_tiny.tiny_cell(workload, seed=2 ** 31 + 7, trace=True)
    if "traced_iterations" in cell.traffic:
        cell.traffic = dict(cell.traffic, traced_iterations=1, check_iterations=4)
    driver = load_module(ROOT / "benchmarks" / "drivers" / f"{cell.traffic['driver']}.py")
    out = driver.run(cell, 0.0)
    line = report.result(cell, out, {"platform": "cpu", "kind": "cpu", "count": 1})
    own = {m["name"] for m in load_json(ROOT / "BENCHMARK.json")["per_layer"]
           if report.applies(m, cell)}
    assert ON_THE_CPU[workload] <= set(line["metrics"]) <= own, line["metrics"]
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0, line["metrics"]
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["idle_pct.h7", "idle_pct.fit", "mfu.h7"])
def test_the_profilers_gaps_are_left_out(name, monkeypatch):
    reader = load_module(ROOT / "benchmarks" / "metrics" / f"{name}.py")
    trace = {"window_s": 4.0, "busy_s": 3.0, "profiler_s": 0.5}
    if name.startswith("idle"):
        assert reader.read({"trace": trace}) == pytest.approx(100 * (1 - 3.0 / 3.5))
        assert reader.read({"trace": dict(trace, busy_s=0.0)}) is None
    else:
        ctx = {"trace": trace, "traced": [{}], "ctl": None, "traffic": {"horizon": 7}}
        flops = 2.01e12
        monkeypatch.setattr(reader.step, "iteration", lambda ctl, horizon: flops)
        assert reader.read(ctx) == pytest.approx(100 * flops / (3.5 * reader.peaks.FP32_FLOPS))


def test_weights_follow_from_the_seed():
    n, seed = 64, 2 ** 32 + 5
    a = weights.surrogate(n, 3, seed, torch.device("cpu"))
    b = weights.surrogate(n, 3, seed, torch.device("cpu"))
    c = weights.surrogate(n, 3, seed + 1, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, sum(math.prod(s) for _, s in layout(n)))
    offset = 0
    for name, shape in layout(n):
        leaf = a[:, offset: offset + math.prod(shape)]
        offset += math.prod(shape)
        if ".norm" in name:
            assert torch.all(leaf == (1.0 if name.endswith("weight") else 0.0)), name
        else:
            assert 0 < float(leaf.abs().max()) <= 1.0, name
