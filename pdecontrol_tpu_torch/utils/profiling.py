"""Profiling hooks of the training loop (port of
``pdecontrol_tpu/utils/profiling.py``).

``trace(dir)`` wraps a region in a ``torch.profiler`` trace and writes one
Chrome trace file (viewable in Perfetto or ``chrome://tracing``);
``Throughput`` tracks steps/sec; ``GCMonitor`` the garbage collector's
pauses; ``FiniteChecks`` is the ``--debug_nans`` check at phase boundaries.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Dict]:
    """Capture a profiler trace of the enclosed region: host operators and,
    with a CUDA device, the kernels they launch.  On exit the trace goes to
    ``<log_dir>/trace-<unix time>.json``; the yielded dict then holds its
    ``path``, the seconds the traced region took (``wall_s``, the profiler's
    overhead included) and the seconds the export took (``export_s``).  An eager
    iteration of the MBPO loop launches tens of thousands of kernels, so the
    file is large and the export slow: trace one iteration, not a run."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    result: Dict = {}
    prof = profile(activities=activities)
    prof.start()
    t_start = time.perf_counter()
    try:
        yield result
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_start
        prof.stop()
        t0 = time.perf_counter()
        path = os.path.join(log_dir, f"trace-{int(time.time())}.json")
        prof.export_chrome_trace(path)
        result.update(path=path, wall_s=wall_s, export_s=time.perf_counter() - t0)


class FiniteChecks:
    """The ``--debug_nans`` checks.  Eager PyTorch has no per-operation NaN
    trap for forward values (``torch.autograd.set_detect_anomaly`` covers the
    backward passes), so the loops call this at their phase boundaries; the
    first non-finite value raises a ``FloatingPointError`` that names the
    phase and the iteration.  Every check waits for the device, which is
    why it is a debug option: an owner that was not asked for it holds
    ``None`` in place of an instance and checks nothing."""

    def __init__(self) -> None:
        self.iteration: Optional[int] = None  # set by the loop that owns it

    def __call__(self, phase: str, **values: torch.Tensor) -> None:
        for name, value in values.items():
            if not bool(torch.isfinite(value).all()):
                raise FloatingPointError(
                    f"non-finite {name} in {phase} at iteration {self.iteration}")


class Throughput:
    """Steps/sec counter with exponential smoothing."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self._last_t: Optional[float] = None
        self._last_n = 0
        self.rate = 0.0

    def update(self, n_steps: int) -> float:
        now = time.perf_counter()
        if self._last_t is not None:
            dt = now - self._last_t
            inst = (n_steps - self._last_n) / max(dt, 1e-9)
            self.rate = (
                inst if self.rate == 0.0
                else self.smoothing * self.rate + (1 - self.smoothing) * inst
            )
        self._last_t, self._last_n = now, n_steps
        return self.rate


class GCMonitor:
    """Accumulates CPython cyclic-GC pause time between ``drain()`` calls
    (pause total/max and per-generation counts beside the ``t_*`` fields of
    a retrain)."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self.pause = 0.0
        self.counts = [0, 0, 0]
        self.max_pause = 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.pause += dt
            self.max_pause = max(self.max_pause, dt)
            self.counts[info["generation"]] += 1
            self._t0 = None

    def drain(self) -> Tuple[float, float, Tuple[int, int, int]]:
        """(total pause s, max single pause s, per-generation counts) since
        the previous drain."""
        out = (self.pause, self.max_pause, tuple(self.counts))
        self.pause = 0.0
        self.max_pause = 0.0
        self.counts = [0, 0, 0]
        return out

    def close(self) -> None:
        try:
            gc.callbacks.remove(self._cb)
        except ValueError:
            pass
