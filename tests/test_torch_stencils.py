"""The public names of the port's ``ops/stencils.py`` and ``data/types.py``
that mirror the JAX package's (``pdecontrol_tpu/ops/stencils.py`` and
``pdecontrol_tpu/data/types.py``): the same numpy inputs give the same
arrays, and ``TrainBatch`` has the JAX record's fields."""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrol_tpu.data import types as JT
from pdecontrol_tpu.ops import stencils as JS
from pdecontrol_tpu_torch.data import types as TT
from pdecontrol_tpu_torch.ops import stencils as TS

TAPS = ["FIRST_DERIV_CENTRAL_2", "FIRST_DERIV_UPWIND_BWD", "FIRST_DERIV_UPWIND_FWD",
        "FOURTH_DERIV_CENTRAL_6", "SECOND_DERIV_CENTRAL_4", "SECOND_DERIV_CENTRAL_6"]


@pytest.mark.parametrize("name", TAPS)
def test_taps_match_jax(name):
    assert dict(getattr(TS, name)) == dict(getattr(JS, name))


@pytest.mark.parametrize("width", [None, 11])
@pytest.mark.parametrize("name", TAPS)
def test_taps_to_kernel_matches_jax(name, width):
    taps = getattr(TS, name)
    got = TS.taps_to_kernel(taps, width)
    want = JS.taps_to_kernel(getattr(JS, name), width)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", TAPS)
def test_apply_taps_numpy_matches_jax_and_the_matrix(name):
    u = np.random.default_rng(0).normal(size=(3, 2, 32))
    got = TS.apply_taps_numpy(u, getattr(TS, name))
    np.testing.assert_array_equal(got, JS.apply_taps_numpy(u, getattr(JS, name)))
    # The circulant form computes the same sums.
    np.testing.assert_allclose(got, u @ TS.circulant(getattr(TS, name), 32).T,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [3, 8, 9, 64, 1024])
@pytest.mark.parametrize("name", TAPS)
def test_circulant_matches_jax(name, n):
    """The port builds the circulant a tap at a time, the JAX package an
    entry at a time: bit-equal, also where n is below the stencil's width
    and taps share an entry."""
    for dtype in (np.float64, np.float32):
        got = TS.circulant(getattr(TS, name), n, dtype)
        want = JS.circulant(getattr(JS, name), n, dtype)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,order", [("FIRST_DERIV_CENTRAL_2", 1),
                                        ("SECOND_DERIV_CENTRAL_6", 2),
                                        ("FOURTH_DERIV_CENTRAL_6", 4)])
def test_derivative_matrix_matches_jax(name, order, dtype):
    dx = 22.0 / 64
    got = TS.derivative_matrix(getattr(TS, name), 64, dx, order, dtype)
    want = JS.derivative_matrix(getattr(JS, name), 64, dx, order, dtype)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def test_train_batch_has_the_jax_fields():
    sample = TT.Sample(obs=torch.zeros((2, 5, 1, 8)), actions=torch.zeros((2, 5, 1, 4)))
    mask = torch.ones((2, 5))
    batch = TT.TrainBatch(sample=sample, mask=mask)
    assert [f.name for f in dataclasses.fields(batch)] == list(
        JT.TrainBatch.__dataclass_fields__)
    assert batch.sample is sample and batch.mask is mask
    assert TT.TrainBatch() == TT.TrainBatch(sample=None, mask=None)
