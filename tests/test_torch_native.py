"""The port's native C++ solver (``pdecontrol_tpu_torch/utils/native.py``):
the same ``native/ks_solver.cc`` as the JAX package's, built into
``build/native/`` and never into ``native/``.  Held to the scipy oracle at
the tolerances of ``tests/test_solver.py:240-262`` and to the port's plain
float64 solver."""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from pdecontrol_tpu_torch.ops.kuramoto import DISSIPATION, L2CONTROL, KSOperators
from pdecontrol_tpu_torch.ops.kuramoto import ks_control_period as plain_period
from pdecontrol_tpu_torch.utils import native
from tests.oracles import KSOracle

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRACKED = ROOT / "native" / "libks_solver.so"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.4, 0.4, size=n)


def test_builds_under_build_and_leaves_the_tracked_library_alone():
    before = hashlib.sha256(TRACKED.read_bytes()).hexdigest()
    lib = native.build()
    native.ks_control_period(_field(1), np.zeros(64), 22.0 / 64, 1e-3, 5)
    assert lib.is_file() and lib.parent.parent == ROOT / "build" / "native"
    assert native.library_path() == lib
    assert hashlib.sha256(TRACKED.read_bytes()).hexdigest() == before


def test_native_solver_matches_scipy_oracle():
    oracle = KSOracle()
    u = _field(9)
    phi = 0.2 * np.sin(2 * np.pi * np.arange(64) / 64)

    np.testing.assert_allclose(native.ks_rhs(u, phi, oracle.dx), oracle.rhs(u, phi)[0],
                               rtol=1e-12, atol=1e-12)
    got_u, got_r = native.ks_control_period(u, phi, oracle.dx, 1e-3, 250)
    exp_u, exp_r = oracle.control_period(u, phi)
    np.testing.assert_allclose(got_u, exp_u, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got_r, exp_r, rtol=1e-9)

    oracle_d = KSOracle(objective="")
    oracle_d.cfg_steps = 50
    _, got_rd = native.ks_control_period(u, phi, oracle.dx, 1e-3, 50, objective="dissipation")
    np.testing.assert_allclose(got_rd, oracle_d.control_period(u, phi)[1], rtol=1e-9)


@pytest.mark.parametrize("objective", [L2CONTROL, DISSIPATION])
def test_native_solver_matches_the_plain_solver(objective):
    """A batch of 10 (the flagship's envs) over one 250-sub-step period, in
    float64."""
    rng = np.random.default_rng(3)
    u = rng.uniform(-1.5, 1.5, (10, 64))
    phi = 0.3 * np.sin(2 * np.pi * np.arange(64) / 64)[None] * rng.uniform(-1, 1, (10, 1))
    ops = KSOperators.create(64, 22.0, dtype=torch.float64)
    want_u, want_r = plain_period(ops, torch.as_tensor(u), torch.as_tensor(phi), 1e-3, 250,
                                  objective)
    got_u, got_r = native.ks_control_period(u, phi, ops.dx, 1e-3, 250, objective)
    np.testing.assert_allclose(got_u, want_u.numpy(), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got_r, want_r.numpy(), rtol=1e-9)
