"""Throughput and GC counters of the training loop (port of
``pdecontrol_tpu/utils/profiling.py`` without its device trace, which is not
ported yet)."""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional, Tuple


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
