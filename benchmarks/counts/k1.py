"""K1, the fused KS control period (``csrc/ks_control_period.cu``): its
operations and bytes per launch.

Per grid point and RK4 sub-step, by direct stencil: per right-hand side 21
taps as fused multiply-adds (u_xx 7, u_xxxx 9, and the one 5-tap upwind
sum that the sign of the stage value picks; 2 FLOPs each) and 8 for the
square, the combine and the stage input; four right-hand sides and 10 for
the RK4 combine and the reward.  Bytes: ``u`` and ``phi`` read once, ``u``
and the reward written once, float32.
"""

from benchmarks.counts import peaks

FLOPS_PER_POINT_STEP = 4 * (2 * 21 + 8) + 10  # 210, all float32
KERNEL_NAMES = ("ks_control_period_kernel", "ks_control_period_general_kernel")


def flops(rows: int, n: int, cfg_steps: int) -> float:
    return float(rows * n * cfg_steps * FLOPS_PER_POINT_STEP)


def bytes_moved(rows: int, n: int) -> float:
    return float(4 * (3 * rows * n + rows))


def bound_s(rows: int, n: int, cfg_steps: int) -> float:
    """The least time one launch could take: the larger of its operations
    over the float32 peak and its bytes over the memory rate."""
    return max(flops(rows, n, cfg_steps) / peaks.FP32_FLOPS,
               bytes_moved(rows, n) / peaks.HBM_BYTES_PER_S)


def is_k1(kernel_name: str) -> bool:
    """A trace's name of a K1 launch: demangled (``void
    ks_control_period_kernel<2>(float const*, ...)``) or mangled; K2's
    kernels (``ks_control_period_limb_*``) are not K1."""
    return any(k in kernel_name for k in KERNEL_NAMES)
