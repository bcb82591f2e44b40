"""The plain reference against the program at a tiny size on the CPU: the
same draws, the same answers to rounding.  This is what lets the reference
judge the program on the card."""

import pytest
import torch

import bench_tiny
from benchmarks.harness.cell import ROOT, load_module
from benchmarks.reference import surrogate as S

WORKLOADS = ("ks_autoreg-h7", "ks_autoreg-retrain", "ks_latent_r4-retrain")


def run_tiny(workload, seed=3):
    cell = bench_tiny.tiny_cell(workload, seed)
    driver = load_module(ROOT / "benchmarks" / "drivers" / f"{cell.traffic['driver']}.py")
    return cell, driver.run(cell, 0.0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_follows_the_program(workload):
    _, out = run_tiny(workload)
    for name, value in out["values"].items():
        assert value < 1e-4, (name, value)


@pytest.mark.parametrize("factory", sorted(S.FAMILIES))
@pytest.mark.parametrize("n", [32, 64])
def test_layout_is_the_programs(factory, n):
    from pdecontrol_tpu_torch.models import factories

    module = factories.make(factory, delta=0.25, N=n)
    assert [(k, tuple(p.shape)) for k, p in module.named_parameters()] == S.layout(n)


@pytest.mark.parametrize("factory", sorted(S.FAMILIES))
def test_rollout_is_the_programs(factory):
    """One teacher-forced rollout of a module with seeded weights, through
    the reference's functions of its flat parameters."""
    from pdecontrol_tpu_torch.envs.transforms import Normalize
    from pdecontrol_tpu_torch.models import factories
    from pdecontrol_tpu_torch.models.surrogate import stack_parameters

    torch.manual_seed(0)
    module = factories.make(factory, delta=0.25, N=32).double()
    flat = stack_parameters([module])[0]
    und = Normalize.create((1, 1, 32), aggregate=True, batched=True, dtype=torch.float64)
    und = und.replace(mean=und.mean + 0.1, var=und.var + 0.3, count=und.count + 1)
    states = torch.randn(3, 4, 1, 32, dtype=torch.float64)
    actions = torch.randn(3, 9, 1, 32, dtype=torch.float64)
    mask = [False] * 6 + [True] + [False] * 2
    roll = module.rollout(states, actions, dscaling=und.inv, reencode=mask)
    out, deltas, _ = S.rollout(S.unflatten(flat, 32), S.FAMILIES[factory], states, actions,
                               0.25, und.mean, torch.sqrt(und.var + und.epsilon),
                               reencode=mask)
    torch.testing.assert_close(out, roll.outputs, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(deltas, roll.deltas, rtol=1e-10, atol=1e-12)
