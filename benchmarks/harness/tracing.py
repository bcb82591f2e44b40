"""A profiler trace of a span of the window: what ran on the device, for how
long, and what the host was doing while the device stood idle.

The span runs under ``torch.profiler`` with CPU and CUDA activity (the
method of ``pdecontrol_tpu_torch/utils/profiling.py::trace``); nothing is
written to disk.  The device's busy time is the union of its kernel, copy
and set intervals; an idle gap is a stretch between them, named by the
innermost host operation or benchmark span that covers its middle.  The
gaps under the profiler's own host events (``PROFILER_EVENTS``: CUPTI's
buffer flushes and requests, which an untraced run does not have) are
counted apart as ``profiler_s``, for the per-layer metrics to leave out.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PROFILER_EVENTS = ("Buffer Flush", "Activity Buffer Request")


class TracedSpan:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if self.cuda else []))
        self.t0 = self.t1 = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Close the span; returns the seconds the profiler took to stop
        (it gathers its events then)."""
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        return time.perf_counter() - self.t1

    def summary(self) -> Dict:
        """``busy_s``, ``window_s``, ``profiler_s``, device time and count by
        kernel name, and the breakdown: the ten device operations that took
        most time and the ten host operations under which the device stood
        idle longest."""
        device: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        for e in self.prof.profiler.kineto_results.events():
            dt = str(e.device_type())
            start, dur = e.start_ns(), e.duration_ns()
            if dt.endswith("CUDA"):
                device.append((start, start + dur, e.name()))
            elif dt.endswith("CPU") and dur > 0:
                host.append((start, start + dur, e.name()))
        by_name: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for s, t, name in device:
            by_name[name] += (t - s) * 1e-9
            counts[name] += 1
        device.sort()
        merged: List[List[int]] = []
        for s, t, _ in device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged) * 1e-9
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:500]
        idle = _name_gaps(gaps, host)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": self.t1 - self.t0,
                "profiler_s": sum(s for n, s in idle if n in PROFILER_EVENTS),
                "kernels": dict(by_name), "kernel_counts": dict(counts),
                "breakdown": {"device_ops": [[n, s] for n, s in ops],
                              "idle_gaps": [[n, s] for n, s in idle[:10]]}}


def own_span_s(trace: Dict) -> float:
    """The traced span less the device's idle gaps under the profiler's own
    host events."""
    return trace["window_s"] - trace["profiler_s"]


def time_replays(fn, replays: int) -> float:
    """Milliseconds per call of ``fn`` (a phase graph's replay; its first
    call runs and captures), by CUDA events around ``replays`` calls."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def _name_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host event covering each gap's middle
    (the 500 longest gaps)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    total: Dict[str, float] = defaultdict(float)
    for length, s, t in gaps:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid)
        best: Optional[Tuple[int, str]] = None
        # The covering events start at or before the middle; look back over
        # a bounded stretch for the shortest one.
        for j in range(i - 1, max(i - 4000, -1), -1):
            hs, ht, name = host[j]
            if ht >= mid and (best is None or ht - hs < best[0]):
                best = (ht - hs, name)
        total[best[1] if best else "(no host event)"] += length * 1e-9
    return sorted(total.items(), key=lambda kv: -kv[1])
