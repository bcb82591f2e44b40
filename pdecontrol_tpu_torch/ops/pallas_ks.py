"""K1: the fused KS control period — a hand-written CUDA kernel for Hopper
(port of ``pdecontrol_tpu/ops/pallas_ks.py``).

``ks_control_period`` advances a float32 batch ``[B, N]`` by one control
period and returns ``(u_next [B, N], reward [B])``, as
``ks_control_period_pallas`` does in the JAX package:

  * for a tensor on the GPU it launches the CUDA kernel
    ``csrc/ks_control_period.cu`` (built at first use, one launch per
    period, one warp per row: a register path for n = 32, 64, ..., 256 and
    a shared-memory path for every other n) or raises;
  * for a tensor on the CPU it runs ``ks_control_period_plain``, this
    module's plain PyTorch version of the same arithmetic (the TPU kernel's
    ``[u | u^2] @ W`` form with the block-diagonal ``fused_stencil_matrix``).

The kernels take every grid of ``MIN_N`` to ``MAX_N`` points, on either
device: below 9 the 9-point stencil wraps onto itself, and 1,024 is where
the JAX kernel's ``[2N, 4N]`` operator fills 32 MiB of VMEM.  Outside that
range the wrapper raises ``ValueError`` before any launch.

``launch_count`` counts the kernel's launches, so that a run can show it
went through the kernel, and ``rows_launched`` the rows they stepped.  A
launch inside a CUDA graph's capture runs nothing: ``utils/graphs.py``
takes it back out and adds it on every replay.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from pdecontrol_tpu_torch.ops.kuramoto import DISSIPATION, L2CONTROL, KSOperators

SOURCE = "ks_control_period.cu"
#: The grids the kernels take (K1 and K2 alike).
MIN_N, MAX_N = 9, 1024

#: Launches of the CUDA kernel since import (or since a caller reset it).
launch_count = 0
#: Rows (envs) those launches stepped.
rows_launched = 0


@functools.lru_cache(maxsize=16)
def fused_stencil_matrix(ops: KSOperators) -> np.ndarray:
    """Block-diagonal ``[2N, 4N]`` operator: rows [0, N) hold the central
    stack (-> u_xx | u_xxxx), rows [N, 2N) the upwind stack (-> fwd | bwd),
    so ``[u | u^2] @ W`` yields all four derivative fields."""
    n = ops.n
    w = np.zeros((2 * n, 4 * n), np.float32)
    w[:n, : 2 * n] = ops.central.detach().cpu().numpy().astype(np.float32)
    w[n:, 2 * n :] = ops.upwind.detach().cpu().numpy().astype(np.float32)
    return w


@functools.lru_cache(maxsize=16)
def stencil_taps(ops: KSOperators) -> np.ndarray:
    """The kernel's 26 float32 taps, read out of the operator matrices:
    u_xx at offsets -3..3, u_xxxx at -4..4, the forward upwind of u^2 at
    0..4 and the backward one at -4..0.  Column 0 of each circulant block
    holds the coefficient of ``u[d]`` at row ``d mod N``."""
    n = ops.n
    if n < 9:
        raise ValueError(f"stencil taps overlap on a grid of {n} < 9 points")
    central = ops.central.detach().cpu().numpy().astype(np.float32)
    upwind = ops.upwind.detach().cpu().numpy().astype(np.float32)
    c2 = [central[d % n, 0] for d in range(-3, 4)]
    c4 = [central[d % n, n] for d in range(-4, 5)]
    fw = [upwind[d % n, 0] for d in range(0, 5)]
    bw = [upwind[d % n, n] for d in range(-4, 1)]
    return np.ascontiguousarray(np.array(c2 + c4 + fw + bw, np.float32))


def check_grid(n: int) -> None:
    """Raise ``ValueError`` for a grid outside ``[MIN_N, MAX_N]``."""
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"the KS kernels take grids of {MIN_N} to {MAX_N} points, got {n}")


def ks_control_period_plain(
    ops: KSOperators,
    u: torch.Tensor,
    phi: torch.Tensor,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: float32, one ``[B, 2N] @
    [2N, 4N]`` product per RHS evaluation, as the TPU kernel's body."""
    n = u.shape[-1]
    w = torch.as_tensor(fused_stencil_matrix(ops), device=u.device)
    u = u.to(torch.float32)
    phi = torch.broadcast_to(phi.to(torch.float32), u.shape)

    def rhs(v):
        y = torch.cat([v, v * v], dim=1) @ w
        u_xx, u_xxxx = y[:, :n], y[:, n : 2 * n]
        fwd, bwd = y[:, 2 * n : 3 * n], y[:, 3 * n :]
        u_x = torch.where(v < 0, fwd, bwd)
        return -u_xxxx - u_xx - 0.5 * u_x + phi, u_x, u_xx

    acc = torch.zeros(u.shape[0], dtype=torch.float32, device=u.device)
    for _ in range(cfg_steps):
        k1, u_x, u_xx = rhs(u)
        if objective == L2CONTROL:
            acc = acc - torch.sum(u * u, dim=1) * (1.0 / n)
        else:
            acc = acc - (
                torch.mean(u_xx * u_xx, dim=1)
                + torch.mean(u_x * u_x, dim=1)
                + torch.mean(u * phi, dim=1)
            )
        k2, _, _ = rhs(u + dt * k1 / 2.0)
        k3, _, _ = rhs(u + dt * k2 / 2.0)
        k4, _, _ = rhs(u + dt * k3)
        u = u + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    return u, acc / cfg_steps


def _library() -> ctypes.CDLL:
    from pdecontrol_tpu_torch.ops import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.ks_control_period_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel now (otherwise its first launch does)."""
    _library()


def ks_control_period(
    ops: KSOperators,
    u: torch.Tensor,
    phi: torch.Tensor,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One KS control period of a batch ``u`` [B, N] under forcing ``phi``
    (broadcast to ``u``): the CUDA kernel for GPU tensors, the plain version
    for CPU tensors."""
    global launch_count, rows_launched
    if u.ndim != 2:
        raise ValueError(f"expected batched [B, N] state, got {tuple(u.shape)}")
    if objective not in (L2CONTROL, DISSIPATION):
        raise ValueError(f"unknown objective {objective!r}")
    if u.shape[1] != ops.n:
        raise ValueError(f"state has {u.shape[1]} points, operators {ops.n}")
    check_grid(ops.n)
    if u.device.type == "cpu":
        return ks_control_period_plain(ops, u, phi, dt, cfg_steps, objective)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    if u.dtype != torch.float32 or phi.dtype != torch.float32:
        raise TypeError(f"the kernel is float32-only, got {u.dtype} / {phi.dtype}")
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
    taps = stencil_taps(ops)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.ks_control_period_f32(
            u.data_ptr(), phi.data_ptr(), u_out.data_ptr(), rew.data_ptr(),
            b, n, float(dt), int(cfg_steps), int(objective == DISSIPATION),
            taps.ctypes.data, stream,
        )
    if err != 0:
        raise RuntimeError(f"ks_control_period kernel launch failed: CUDA error {err}")
    launch_count += 1
    rows_launched += b
    return u_out, rew
