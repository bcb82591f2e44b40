"""K2: the KS control period in bf16-limb precision — a hand-written CUDA
kernel for Hopper (port of ``pdecontrol_tpu/ops/pallas_ks_packed.py``).

The TPU kernel packs two batch rows into each 128-lane register and runs
every derivative as a matrix product on the MXU, at a selectable precision:

  * ``"highest"`` — float32 with the pre-summed linear operator
    ``-(c_xx + c_xxxx)``: K1's arithmetic up to float32 rounding, so the
    port routes it to K1 (``ops/pallas_ks.py``);
  * ``"bf16"`` — one pass: ``bf16(x) @ bf16(W)``;
  * ``"bf16_3x"`` — ``hi @ W_hi + hi @ W_lo + lo @ W_hi`` with the limbs
    ``hi = bf16(x)``, ``lo = bf16(x - hi)``, ``W_hi = bf16(W)``,
    ``W_lo = bf16(W - W_hi)``;
  * ``"bf16_4x"`` — adds ``lo @ W_lo``.

Every rounding is round-to-nearest-even and every product accumulates in
float32: what the MXU does, since it rounds each float32 operand of a
default-precision pass to bf16.  (The JAX package run on the CPU computes
something else for the limb modes: XLA keeps the float32 ``W`` of the
``hi @ W`` pass unrounded, so ``W_lo`` counts twice.  ``limb_dot`` here is
the TPU arithmetic.)

The limb modes use the separate-block linear operator ``[-c_xx | -c_xxxx]``
and add the two halves in float32 after the product: pre-summing the two
derivative scales before the bf16 split biases the attractor (see
``pdecontrol_tpu/ops/pallas_ks_packed.py``).  The dissipation objective adds
a ``u_xx`` product on the pre-step state.

The lane packing means nothing on Hopper and is dropped: the ``[N, .]``
diagonal blocks of the packed operators act on a ``[B, N]`` batch.  The
operator builders keep the packed layout and the JAX names, so they can be
held bit-equal to the JAX ones.

``ks_control_period_packed`` launches ``csrc/ks_control_period_limb.cu`` for
a float32 batch on the GPU (built at first use, one launch per period; a
register path for n = 32, 64, ..., 256, a shared-memory path for the other
grids) or raises, and runs ``ks_control_period_packed_plain`` for one on
the CPU.  It takes K1's grids, ``pallas_ks.MIN_N`` to ``MAX_N`` points, and
raises ``ValueError`` outside them before any launch.
``launch_count`` counts the kernel's launches (a CUDA graph's replays
included, see ``utils/graphs.py``), and ``rows_launched`` the rows they
stepped.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from pdecontrol_tpu_torch.ops import pallas_ks
from pdecontrol_tpu_torch.ops.kuramoto import DISSIPATION, L2CONTROL, KSOperators

SOURCE = "ks_control_period_limb.cu"
PRECISIONS = ("highest", "bf16", "bf16_3x", "bf16_4x")
#: bf16 matrix passes of each limb mode; the kernel is templated on it.
LIMB_PASSES = {"bf16": 1, "bf16_3x": 3, "bf16_4x": 4}

#: Launches of the CUDA kernel since import (or since a caller reset it).
launch_count = 0
#: Rows (envs) those launches stepped.
rows_launched = 0


def _operator_f64(ops: KSOperators) -> Tuple[np.ndarray, np.ndarray]:
    central = ops.central.detach().cpu().numpy().astype(np.float64)
    upwind = ops.upwind.detach().cpu().numpy().astype(np.float64)
    return central, upwind


def packed_matrices(ops: KSOperators) -> Tuple[np.ndarray, np.ndarray]:
    """(W_lin [2N, 2N], W_up [2N, 4N]) block-diagonal packed operators:
    ``-(u_xx + u_xxxx)`` of each packed row, and the forward | backward
    upwind derivatives of ``u^2`` (cols [0, 2N) fwd, [2N, 4N) bwd)."""
    n = ops.n
    cen, up = _operator_f64(ops)
    a = -(cen[:, :n] + cen[:, n:])
    w_lin = np.zeros((2 * n, 2 * n), np.float32)
    w_lin[:n, :n] = a
    w_lin[n:, n:] = a
    w_up = np.zeros((2 * n, 4 * n), np.float32)
    w_up[:n, :n] = up[:, :n]
    w_up[n:, n : 2 * n] = up[:, :n]
    w_up[:n, 2 * n : 3 * n] = up[:, n:]
    w_up[n:, 3 * n :] = up[:, n:]
    return w_lin, w_up


def packed_linear_separate(ops: KSOperators) -> np.ndarray:
    """``[2N, 4N]`` separate-block linear operator of the limb modes: cols
    ``[0, 2N)`` give packed ``-u_xx``, cols ``[2N, 4N)`` packed ``-u_xxxx``."""
    n = ops.n
    cen, _ = _operator_f64(ops)
    w = np.zeros((2 * n, 4 * n), np.float32)
    w[:n, :n] = -cen[:, :n]
    w[n:, n : 2 * n] = -cen[:, :n]
    w[:n, 2 * n : 3 * n] = -cen[:, n:]
    w[n:, 3 * n :] = -cen[:, n:]
    return w


def packed_uxx_matrix(ops: KSOperators) -> np.ndarray:
    """Packed ``[2N, 2N]`` block-diagonal ``u_xx`` operator (dissipation)."""
    n = ops.n
    cen, _ = _operator_f64(ops)
    w = np.zeros((2 * n, 2 * n), np.float32)
    w[:n, :n] = cen[:, :n]
    w[n:, n:] = cen[:, :n]
    return w


def unpacked_operators(ops: KSOperators, precision: str) -> Dict[str, np.ndarray]:
    """The operators the period multiplies a ``[B, N]`` batch by: the
    diagonal blocks of the packed ones.  ``lin`` is ``[N, N]`` (pre-summed,
    ``highest``) or ``[N, 2N]`` (``-c_xx | -c_xxxx``, the limb modes);
    ``up`` is ``[N, 2N]`` (fwd | bwd); ``uxx`` is ``[N, N]``."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    n = ops.n
    w_lin, w_up = packed_matrices(ops)
    if precision == "highest":
        lin = w_lin[:n, :n]
    else:
        sep = packed_linear_separate(ops)
        lin = np.concatenate([sep[:n, :n], sep[:n, 2 * n : 3 * n]], axis=1)
    up = np.concatenate([w_up[:n, :n], w_up[:n, 2 * n : 3 * n]], axis=1)
    uxx = packed_uxx_matrix(ops)[:n, :n]
    return {k: np.ascontiguousarray(v) for k, v in
            (("lin", lin), ("up", up), ("uxx", uxx))}


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bf16 (nearest, ties to even), kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def limbs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-limb split ``x ~ hi + lo`` with both limbs bf16-valued."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


def limb_dot(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` with the TPU's arithmetic at ``precision``: float32
    products of bf16-rounded operands, accumulated in float32.  (A bf16
    torch matmul would round its output to bf16: not used.)"""
    if precision == "highest":
        return x @ w
    if precision not in LIMB_PASSES:
        raise ValueError(f"unknown precision {precision!r}")
    x_hi, x_lo = limbs(x)
    w_hi, w_lo = limbs(w)
    y = x_hi @ w_hi
    if precision == "bf16":
        return y
    y = y + x_hi @ w_lo
    y = y + x_lo @ w_hi
    if precision == "bf16_4x":
        y = y + x_lo @ w_lo
    return y


def ks_control_period_packed_plain(
    ops: KSOperators,
    u: torch.Tensor,
    phi: torch.Tensor,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: the TPU kernel's body
    (``pallas_ks_packed._kernel``) on a ``[B, N]`` float32 batch."""
    n = u.shape[-1]
    mats = unpacked_operators(ops, precision)
    wl, wu, wxx = (torch.as_tensor(mats[k], device=u.device) for k in ("lin", "up", "uxx"))
    u = u.to(torch.float32)
    phi = torch.broadcast_to(phi.to(torch.float32), u.shape)

    def rhs(x):
        lin = limb_dot(x, wl, precision)
        if lin.shape[-1] == 2 * n:  # separate-block layout (limb modes)
            lin = lin[:, :n] + lin[:, n:]
        y = limb_dot(x * x, wu, precision)
        ux = torch.where(x < 0, y[:, :n], y[:, n:])
        return lin - 0.5 * ux + phi, ux

    acc = torch.zeros(u.shape[0], dtype=torch.float32, device=u.device)
    for _ in range(cfg_steps):
        k1, ux = rhs(u)
        if objective == L2CONTROL:
            r = -torch.sum(u * u, dim=1) * (1.0 / n)
        else:
            uxx = limb_dot(u, wxx, precision)
            r = -(torch.sum(uxx * uxx, dim=1) * (1.0 / n)
                  + torch.sum(ux * ux, dim=1) * (1.0 / n)
                  + torch.sum(u * phi, dim=1) * (1.0 / n))
        acc = acc + r
        k2, _ = rhs(u + dt * k1 / 2.0)
        k3, _ = rhs(u + dt * k2 / 2.0)
        k4, _ = rhs(u + dt * k3)
        u = u + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    return u, acc / cfg_steps


@functools.lru_cache(maxsize=16)
def limb_taps(ops: KSOperators) -> np.ndarray:
    """The kernel's 52 float32 taps: the bf16 hi and lo limbs of the 26
    nonzero entries of the limb-mode operators (``-c_xx`` at offsets -3..3,
    ``-c_xxxx`` at -4..4, the forward upwind at 0..4, the backward at -4..0),
    read out of the matrices as K1's ``stencil_taps`` reads them.  Layout:
    ``[-c_xx hi(7), lo(7), -c_xxxx hi(9), lo(9), fwd hi(5), lo(5),
    bwd hi(5), lo(5)]``."""
    taps = torch.as_tensor(pallas_ks.stencil_taps(ops))
    signed = torch.cat([-taps[:16], taps[16:]])  # the linear blocks are negated
    hi, lo = limbs(signed)
    parts = []
    for a, b in ((0, 7), (7, 16), (16, 21), (21, 26)):
        parts += [hi[a:b], lo[a:b]]
    return np.ascontiguousarray(torch.cat(parts).numpy().astype(np.float32))


def _library() -> ctypes.CDLL:
    from pdecontrol_tpu_torch.ops import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.ks_control_period_limb
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel now (otherwise its first launch does)."""
    _library()


def ks_control_period_packed(
    ops: KSOperators,
    u: torch.Tensor,
    phi: torch.Tensor,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One KS control period of a float32 batch ``u`` [B, N] under forcing
    ``phi`` (broadcast to ``u``) at ``precision``: ``highest`` is K1; a
    limb mode is the CUDA kernel for GPU tensors and the plain version for
    CPU tensors."""
    global launch_count, rows_launched
    if objective not in (L2CONTROL, DISSIPATION):
        raise ValueError(f"unknown objective {objective!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if u.ndim != 2:
        raise ValueError(f"expected batched [B, N] state, got {tuple(u.shape)}")
    if u.shape[1] != ops.n:
        raise ValueError(f"state has {u.shape[1]} points, operators {ops.n}")
    pallas_ks.check_grid(ops.n)
    if u.dtype != torch.float32 or phi.dtype != torch.float32:
        raise TypeError(f"the kernel is float32-only, got {u.dtype} / {phi.dtype}")
    if precision == "highest":
        return pallas_ks.ks_control_period(ops, u, phi, dt, cfg_steps, objective)
    if u.device.type == "cpu":
        return ks_control_period_packed_plain(ops, u, phi, dt, cfg_steps, objective,
                                              precision)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    if phi.device != u.device:
        raise ValueError(f"phi on {phi.device}, u on {u.device}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    phi = torch.broadcast_to(phi, u.shape).contiguous()
    b, n = u.shape
    u_out = torch.empty_like(u)
    rew = torch.empty((b,), dtype=torch.float32, device=u.device)
    if b == 0:
        return u_out, rew
    taps = limb_taps(ops)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.ks_control_period_limb(
            u.data_ptr(), phi.data_ptr(), u_out.data_ptr(), rew.data_ptr(),
            b, n, float(dt), int(cfg_steps), int(objective == DISSIPATION),
            LIMB_PASSES[precision], taps.ctypes.data, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ks_control_period_limb kernel launch failed: CUDA error {err}")
    launch_count += 1
    rows_launched += b
    return u_out, rew
