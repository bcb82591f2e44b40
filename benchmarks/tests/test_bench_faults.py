"""A run with the timed path broken underneath comes out not correct: each
fault that a cell can have is planted in the program, the rest of the run
is driven as the benchmark drives it (past its look for a card, at the
tiny size on the CPU), and the cell's own limits judge it."""

import contextlib

import pytest
import torch

import bench_tiny
from benchmarks.harness.cell import ROOT, load_module
from benchmarks.harness.compare import judge
from pdecontrol_tpu_torch.ops import pallas_ks
from pdecontrol_tpu_torch.sac.sac import SAC
from pdecontrol_tpu_torch.train.trainer import SurrogateTrainer


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def no_step(old):
    return lambda *a, **k: None


def half_sac_batch(old):
    def update(self, state, batch, generator=None, noise=None):
        half = batch.obs.shape[0] // 2
        return old(self, state, batch.apply(lambda x: x[:half]), generator, noise)
    return update


def altered_reward(old):
    def period(*args, **kwargs):
        u, r = old(*args, **kwargs)
        return u, r * (1 + 1e-3)
    return period


def half_fit_batch(old):
    def step(self, state, states, actions, *args):
        half = states.shape[1] // 2
        return old(self, state, states[:, :half], actions[:, :half], *args)
    return step


def altered_val(old):
    def val(self, *args):
        out = old(self, *args)
        return dict(out, val_loss=out["val_loss"] * (1 + 1e-3))
    return val


FAULTS = {
    "ks_autoreg-h7": {
        "state unchanged": (torch.optim.Adam, "step", no_step),
        "half batch": (SAC, "update", half_sac_batch),
        "answer altered": (pallas_ks, "ks_control_period", altered_reward),
    },
    "retrain": {
        "state unchanged": (SurrogateTrainer, "_adam_", no_step),
        "half batch": (SurrogateTrainer, "lockstep_train_step", half_fit_batch),
        "answer altered": (SurrogateTrainer, "lockstep_val_step", altered_val),
    },
}
CASES = [(w, f) for w in ("ks_autoreg-h7",) for f in FAULTS[w]] + [
    (w, f) for w in ("ks_autoreg-retrain", "ks_latent_r4-retrain") for f in FAULTS["retrain"]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_is_not_correct(workload, fault):
    cell = bench_tiny.tiny_cell(workload, seed=5)
    driver = load_module(ROOT / "benchmarks" / "drivers" / f"{cell.traffic['driver']}.py")
    obj, name, make = FAULTS[workload if workload in FAULTS else "retrain"][fault]
    with patched(obj, name, make):
        out = driver.run(cell, 0.0)
    correct, checks = judge(out["values"], cell.limits)
    assert not correct, checks
