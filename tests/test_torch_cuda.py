"""Kernel K1 on an NVIDIA card: built from the checkout, launched, and held
to its plain PyTorch version (float32, the tolerance of
tests/test_pallas_ks.py).  Every test here needs a card and skips without
one.  This file imports no JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import pdecontrol_tpu_torch  # noqa: F401  (turns TF32 off)

    return torch.device("cuda")


@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
@pytest.mark.parametrize("batch", [12, 8, 1])
def test_kernel_matches_plain_version(dev, objective, batch):
    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    ops = KSOperators.create(64, 22.0, device=dev)
    rng = np.random.default_rng(batch)
    u = torch.as_tensor(rng.uniform(-1, 1, (batch, 64)), dtype=torch.float32, device=dev)
    phi = torch.as_tensor(np.repeat(0.3 * np.sin(2 * np.pi * np.arange(64) / 64)[None],
                                    batch, 0), dtype=torch.float32, device=dev)
    before = pallas_ks.launch_count
    got = pallas_ks.ks_control_period(ops, u, phi, 1e-3, 20, objective)
    torch.cuda.synchronize()
    assert pallas_ks.launch_count == before + 1
    ref = pallas_ks.ks_control_period_plain(ops, u, phi, 1e-3, 20, objective)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-6)


def test_kernel_wrapper_raises_instead_of_falling_back(dev):
    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    ops = KSOperators.create(64, 22.0, device=dev)
    u64 = torch.zeros(4, 64, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        pallas_ks.ks_control_period(ops, u64, u64, 1e-3, 2)
    strided = torch.zeros(64, 8, device=dev).t()
    with pytest.raises(ValueError):
        pallas_ks.ks_control_period(ops, strided, strided, 1e-3, 2)
    ops32 = KSOperators.create(48, 22.0, device=dev)  # not a multiple of 32
    u = torch.zeros(2, 48, device=dev)
    with pytest.raises(RuntimeError):
        pallas_ks.ks_control_period(ops32, u, u, 1e-3, 2)
