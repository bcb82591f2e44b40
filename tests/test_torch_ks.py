"""Port parity of the KS solver: the PyTorch plain path and kernel K1's CPU
path against the JAX package (XLA path and Pallas kernel in interpret mode)
and the NumPy/SciPy oracle, on the same inputs made with numpy."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.ops import kuramoto as jks
from pdecontrol_tpu.ops import pallas_ks as jpallas
from pdecontrol_tpu_torch.ops import cuda_build, pallas_ks, stencils
from pdecontrol_tpu_torch.ops.kuramoto import (
    KSOperators,
    gaussian_forcing_matrix,
    ks_control_period,
    ks_transient,
)

from .oracles import KSOracle

OBJECTIVES = ["l2control", "dissipation"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (b, n)), rng.uniform(-0.5, 0.5, (b, n))


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("dtype,rtol,atol", [
    ("float64", 1e-9, 1e-12),  # same scheme, summation order only
    ("float32", 2e-5, 2e-6),  # tests/test_pallas_ks.py tolerance
])
def test_plain_period_matches_jax(objective, dtype, rtol, atol):
    u, phi = _inputs(0, 6)
    u, phi = u.astype(dtype), phi.astype(dtype)
    jops = jks.KSOperators.create(64, 22.0, dtype=jnp.dtype(dtype))
    ju, jr = jks.ks_control_period(jops, jnp.asarray(u), jnp.asarray(phi), 1e-3, 20,
                                   objective)
    tops = KSOperators.create(64, 22.0, dtype=getattr(torch, dtype))
    tu, tr = ks_control_period(tops, torch.as_tensor(u), torch.as_tensor(phi), 1e-3, 20,
                               objective)
    assert tu.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=rtol, atol=atol)


@pytest.mark.parametrize("oracle_objective,objective", [
    ("dissipation", "l2control"),  # truthy string -> l2control (quirk)
    ("", "dissipation"),
])
def test_plain_period_shadows_oracle(oracle_objective, objective):
    """Restarted from the oracle's state every period, the port reproduces
    its next full control period (250 RK4 sub-steps) to <=1e-9 relative L2
    in float64 (the bar of tests/test_solver.py)."""
    oracle = KSOracle(objective=oracle_objective)
    ops = KSOperators.create(64, 22.0, dtype=torch.float64)
    rng = np.random.default_rng(3)
    u = rng.uniform(-0.4, 0.4, 64)
    f = oracle.forcing_matrix()
    for _ in range(3):
        phi = rng.uniform(-1.0, 1.0, 4) @ f
        u_next, rew = oracle.control_period(u, phi)
        tu, tr = ks_control_period(ops, torch.as_tensor(u), torch.as_tensor(phi),
                                   1e-3, 250, objective)
        assert np.linalg.norm(tu.numpy() - u_next) / np.linalg.norm(u_next) <= 1e-9
        assert abs(float(tr) - rew) / abs(rew) <= 1e-9
        u = u_next


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_kernel_cpu_path_matches_pallas_interpret(objective):
    """K1's wrapper on CPU tensors (its plain version) against the JAX
    Pallas kernel run in interpret mode (tests/test_pallas_ks.py setup)."""
    u, _ = _inputs(1, 8)
    phi = np.repeat(0.3 * np.sin(2 * np.pi * np.arange(64) / 64)[None], 8, 0)
    u, phi = u.astype(np.float32), phi.astype(np.float32)
    jops = jks.KSOperators.create(64, 22.0, dtype=jnp.float32)
    ju, jr = jpallas.ks_control_period_pallas(jops, jnp.asarray(u), jnp.asarray(phi),
                                              1e-3, 20, objective, block=8,
                                              interpret=True)
    ops = KSOperators.create(64, 22.0)
    before = pallas_ks.launch_count
    tu, tr = pallas_ks.ks_control_period(ops, torch.as_tensor(u), torch.as_tensor(phi),
                                         1e-3, 20, objective)
    assert pallas_ks.launch_count == before  # CPU tensors never launch
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-5, atol=2e-6)


def test_kernel_cpu_path_batch12_block8():
    """The batch-12 / block-8 divisor case of tests/test_pallas_ks.py."""
    u, _ = _inputs(2, 12)
    u = u.astype(np.float32)
    phi = np.zeros_like(u)
    jops = jks.KSOperators.create(64, 22.0, dtype=jnp.float32)
    ju, jr = jpallas.ks_control_period_pallas(jops, jnp.asarray(u), jnp.asarray(phi),
                                              1e-3, 4, block=8, interpret=True)
    tu, tr = pallas_ks.ks_control_period(KSOperators.create(64, 22.0), torch.as_tensor(u),
                                         torch.as_tensor(phi), 1e-3, 4)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-5, atol=2e-6)


def test_operators_and_fused_matrix_match_jax():
    jops = jks.KSOperators.create(64, 22.0, dtype=jnp.float32)
    ops = KSOperators.create(64, 22.0)
    np.testing.assert_array_equal(ops.central.numpy(), np.asarray(jops.central))
    np.testing.assert_array_equal(ops.upwind.numpy(), np.asarray(jops.upwind))
    np.testing.assert_array_equal(pallas_ks.fused_stencil_matrix(ops),
                                  jpallas.fused_stencil_matrix(jops))


def test_kernel_taps_are_the_float32_matrix_entries():
    """K1 applies the same float32 coefficients the plain path multiplies by:
    each tap equals float32(c * dx^-k) and sits in the circulant column."""
    ops = KSOperators.create(64, 22.0)
    taps = pallas_ks.stencil_taps(ops)
    dx = 22.0 / 64
    expect = (
        [stencils.SECOND_DERIV_CENTRAL_6[d] / dx**2 for d in range(-3, 4)]
        + [stencils.FOURTH_DERIV_CENTRAL_6[d] / dx**4 for d in range(-4, 5)]
        + [stencils.FIRST_DERIV_UPWIND_FWD[d] / dx for d in range(0, 5)]
        + [stencils.FIRST_DERIV_UPWIND_BWD[d] / dx for d in range(-4, 1)]
    )
    np.testing.assert_array_equal(taps, np.asarray(expect).astype(np.float32))
    u = np.random.default_rng(4).uniform(-1, 1, 64).astype(np.float32)
    direct = sum(taps[3 + d] * np.roll(u, -d) for d in range(-3, 4))
    np.testing.assert_allclose(direct, u @ ops.central.numpy()[:, :64], rtol=1e-5, atol=1e-4)


def test_kernel_wrapper_checks_and_casts():
    ops = KSOperators.create(64, 22.0)
    with pytest.raises(ValueError):
        pallas_ks.ks_control_period(ops, torch.zeros(64), torch.zeros(64), 1e-3, 2)
    with pytest.raises(ValueError):
        pallas_ks.ks_control_period(ops, torch.zeros(2, 32), torch.zeros(2, 32), 1e-3, 2)
    with pytest.raises(ValueError):
        pallas_ks.ks_control_period(ops, torch.zeros(2, 64), torch.zeros(2, 64), 1e-3, 2,
                                    "bogus")
    # A tensor on neither the CPU nor a CUDA card gets no fallback.
    meta = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError):
        pallas_ks.ks_control_period(ops, meta, meta, 1e-3, 2)
    # CPU float64 input is cast to float32, as the JAX entry casts.
    u, phi = _inputs(5, 3)
    tu, tr = pallas_ks.ks_control_period(ops, torch.as_tensor(u), torch.as_tensor(phi),
                                         1e-3, 3)
    assert tu.dtype == torch.float32 and tr.shape == (3,)


def test_transient_through_kernel_wrapper_equals_plain():
    ops = KSOperators.create(16, 22.0)
    u = torch.as_tensor(_inputs(6, 4, n=16)[0], dtype=torch.float32)
    a = ks_transient(ops, u, 1e-3, 5, 3)
    b = ks_transient(ops, u, 1e-3, 5, 3, period_fn=pallas_ks.ks_control_period)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5, atol=2e-6)


def test_gaussian_forcing_matrix_matches_jax():
    x = np.linspace(0.0, 22.0 - 22.0 / 64, 64)
    xi = np.asarray([0.0, 0.25, 0.5, 0.75])
    np.testing.assert_array_equal(gaussian_forcing_matrix(x, xi, 0.4, 22.0),
                                  jks.gaussian_forcing_matrix(x, xi, 0.4, 22.0))


def test_kernel_library_is_built_into_the_ignored_build_dir():
    path = cuda_build.library_path(pallas_ks.SOURCE)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.commonpath([str(path), os.path.join(root, "build", "kernels")]) == \
        os.path.join(root, "build", "kernels")
    ignored = open(os.path.join(root, ".gitignore")).read().split()
    assert "build/" in ignored
    assert "-gencode" in cuda_build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in \
        cuda_build.NVCC_FLAGS
    # The source names the TPU kernel it replaces.
    src = (cuda_build.CSRC / pallas_ks.SOURCE).read_text()
    assert "pdecontrol_tpu/ops/pallas_ks.py::_kernel" in src
