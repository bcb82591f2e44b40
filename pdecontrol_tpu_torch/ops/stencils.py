"""Finite-difference stencils of the KS and Burgers solvers as periodic taps
and circulant matrices.

A copy of ``pdecontrol_tpu.ops.stencils`` (plain numpy), kept in the port so
that importing it never runs the JAX package's ``__init__``.  The reference
solver (pdegym ``kuramoto.py:23-27,118-129``) applies 1-D periodic stencils
with ``scipy.ndimage.convolve1d``, which flips the kernel; here the
**effective cross-correlation taps** are stored directly:

    out[i] = sum_d  taps[d] * u[(i + d) % N]

``stacked_matrix`` materialises several scaled stencils as one ``[N, kN]``
operator so that ``U @ stacked`` evaluates all of them in one matrix product
(the plain path), while the CUDA kernel reads the same float32 coefficients
back out of those matrices and applies the taps directly.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

#: One-sided forward first derivative (used as the upwind branch for u < 0).
FIRST_DERIV_UPWIND_FWD: Mapping[int, float] = {
    0: -25.0 / 12.0,
    1: 4.0,
    2: -3.0,
    3: 4.0 / 3.0,
    4: -1.0 / 4.0,
}

#: One-sided backward first derivative (upwind branch for u >= 0).
FIRST_DERIV_UPWIND_BWD: Mapping[int, float] = {
    0: 25.0 / 12.0,
    -1: -4.0,
    -2: 3.0,
    -3: -4.0 / 3.0,
    -4: 1.0 / 4.0,
}

#: Sixth-order central second derivative.
SECOND_DERIV_CENTRAL_6: Mapping[int, float] = {
    -3: 1.0 / 90.0,
    -2: -3.0 / 20.0,
    -1: 3.0 / 2.0,
    0: -49.0 / 18.0,
    1: 3.0 / 2.0,
    2: -3.0 / 20.0,
    3: 1.0 / 90.0,
}

#: Sixth-order central fourth derivative.
FOURTH_DERIV_CENTRAL_6: Mapping[int, float] = {
    -4: 7.0 / 240.0,
    -3: -2.0 / 5.0,
    -2: 169.0 / 60.0,
    -1: -122.0 / 15.0,
    0: 91.0 / 8.0,
    1: -122.0 / 15.0,
    2: 169.0 / 60.0,
    3: -2.0 / 5.0,
    4: 7.0 / 240.0,
}

#: Second-order central first derivative (Burgers physics loss, phyloss.py:39).
FIRST_DERIV_CENTRAL_2: Mapping[int, float] = {
    -1: -1.0 / 2.0,
    1: 1.0 / 2.0,
}

#: Fourth-order central second derivative (Burgers physics loss, phyloss.py:40).
SECOND_DERIV_CENTRAL_4: Mapping[int, float] = {
    -2: -1.0 / 12.0,
    -1: 4.0 / 3.0,
    0: -5.0 / 2.0,
    1: 4.0 / 3.0,
    2: -1.0 / 12.0,
}


def circulant(taps: Mapping[int, float], n: int, dtype=np.float64) -> np.ndarray:
    """Dense circulant ``D`` with ``(D @ u)[i] = sum_d taps[d] * u[(i+d) % n]``."""
    mat = np.zeros((n, n), dtype=np.float64)
    rows = np.arange(n)
    for d, c in taps.items():
        # One tap's entries are distinct for a fixed d: the per-entry loop's sums.
        mat[rows, (rows + d) % n] += c
    return mat.astype(dtype, copy=False)


def taps_to_kernel(taps: Mapping[int, float], width: int | None = None) -> np.ndarray:
    """The taps as a dense centred correlation kernel."""
    radius = max(abs(d) for d in taps)
    if width is None:
        width = 2 * radius + 1
    center = width // 2
    kernel = np.zeros(width, dtype=np.float64)
    for d, c in taps.items():
        kernel[center + d] = c
    return kernel


def apply_taps_numpy(u: np.ndarray, taps: Mapping[int, float]) -> np.ndarray:
    """The periodic taps applied along the last axis through ``np.roll``
    (the reference for the matrix and kernel forms)."""
    out = np.zeros_like(u)
    for d, c in taps.items():
        out = out + c * np.roll(u, -d, axis=-1)
    return out


def derivative_matrix(
    taps: Mapping[int, float], n: int, dx: float, order: int, dtype=np.float64
) -> np.ndarray:
    """The circulant matrix scaled by ``dx**-order`` (``convolve1d(...) / dx**k``)."""
    return (circulant(taps, n, dtype=np.float64) / dx**order).astype(dtype)


def stacked_matrix(
    taps_list: Sequence[Mapping[int, float]],
    n: int,
    scales: Sequence[float],
    dtype=np.float64,
) -> np.ndarray:
    """Stack scaled stencil matrices into one ``[n, k*n]`` operator.

    ``U @ stacked`` evaluates all ``k`` derivatives in one product; each
    block is the *transposed* circulant so that right-multiplication applies
    the stencil.  Scaling happens in float64 before the cast to ``dtype``.
    """
    blocks = [
        (circulant(taps, n, dtype=np.float64) * s).T
        for taps, s in zip(taps_list, scales)
    ]
    return np.concatenate(blocks, axis=1).astype(dtype)
