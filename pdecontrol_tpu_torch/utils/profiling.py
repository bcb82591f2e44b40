"""Profiling hooks of the training loop (port of
``pdecontrol_tpu/utils/profiling.py``).

``trace(dir)`` wraps a region in a ``torch.profiler`` trace and writes one
Chrome trace file (viewable in Perfetto or ``chrome://tracing``);
``Throughput`` tracks steps/sec; ``GCMonitor`` the garbage collector's
pauses; ``FiniteChecks`` is the ``--debug_nans`` check at phase boundaries.

The loop's own tracing has two parts, both always on:

  * device stamps (``stamp``): a one-thread kernel
    (``csrc/device_stamp.cu``) reads the card's global nanosecond timer into
    a slot of a preallocated int64 tensor, or adds it to the slot with a
    sign, so that a start/end pair replayed N times sums N durations.
    Queued on the stream, a stamp runs when the work before it has
    finished; captured, it is a node of the CUDA graph and runs inside
    every replay.  On the CPU, where eager work is synchronous, a stamp is
    the host's ``perf_counter_ns``;
  * host spans (``Tracer.span``): name, start, end and parent span in
    ``perf_counter_ns``, kept in a bounded ring.  While a ``torch.profiler``
    is active a span also enters a record function (``RecordFunction``), so
    that it sits on the trace's host rows beside the kernels, the stamp
    kernels marking the phase boundaries on the device rows.

``Tracer`` measures the offset between the card's timer and the host's
clock when it is built, so that a stamp can be placed among the spans.
On a CUDA device that first builds the stamp kernel with ``nvcc`` for
``sm_90a`` (``ops/cuda_build.py``), so every CUDA controller, and every
lock-step fit on the card, needs ``nvcc`` and a Hopper card, whether or not
its path launches a hand-written kernel.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import json
import os
import time
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.autograd import _profiler_enabled

# The record function a span enters under a profiler: an operator-like
# record on the host rows.  ``torch.autograd.profiler.record_function``'s
# user annotation would also be mirrored onto the device rows as one event
# over every kernel launched inside it, which a reader of the trace counts
# as device time.
RecordFunction = torch._C._profiler._RecordFunctionFast


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


# ------------------------------------------------------------ device stamps
#: How a stamp writes its slot: the clock itself, or the clock added to the
#: slot, or subtracted from it (``csrc/device_stamp.cu``).
SET, ADD, SUB = 0, 1, 2
STAMP_SOURCE = "device_stamp.cu"


def _stamp_kernel():
    from pdecontrol_tpu_torch.ops import cuda_build

    fn = cuda_build.load(STAMP_SOURCE).device_stamp
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stamp(slots: torch.Tensor, index: int, mode: int = SET) -> None:
    """Write the clock into ``slots[index]`` (an int64 tensor) behind the
    work queued so far, or add it with ``ADD`` / ``SUB``: the card's global
    timer for a tensor on the card, the host's ``perf_counter_ns`` for one
    on the CPU."""
    if slots.device.type != "cuda":
        t = time.perf_counter_ns()
        if mode == SET:
            slots[index] = t
        else:
            slots[index] += t if mode == ADD else -t
        return
    err = _stamp_kernel()(slots.data_ptr() + index * slots.element_size(), mode,
                          torch.cuda.current_stream(slots.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"device stamp launch failed: CUDA error {err}")


def pull_async(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` queued behind the work that computes it: on the
    card a non-blocking copy into pinned memory, complete once the stream
    has reached it; on the CPU a clone."""
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def clock_offset_ns(device: torch.device, tries: int = 8) -> int:
    """The card's global timer less the host's ``perf_counter_ns``, from the
    narrowest of ``tries`` stamps each bracketed by host reads and a
    synchronisation (taken at the bracket's middle); 0 on the CPU, where a
    stamp is the host's clock."""
    if device.type != "cuda":
        return 0
    slot = torch.zeros((1,), dtype=torch.int64, device=device)
    best: Optional[Tuple[int, int]] = None
    for _ in range(tries):
        torch.cuda.synchronize(device)
        h0 = time.perf_counter_ns()
        stamp(slot, 0)
        torch.cuda.synchronize(device)
        h1 = time.perf_counter_ns()
        width, offset = h1 - h0, int(slot.item()) - (h0 + h1) // 2
        if best is None or width < best[0]:
            best = (width, offset)
    return best[1]


# --------------------------------------------------------------- host spans
class Span:
    """One host span; ``Tracer.span`` makes it.  After it closes,
    ``seconds`` is its length; ``fields``, if the owner sets it inside the
    span, goes into the ring with it."""

    __slots__ = ("tracer", "name", "parent", "start", "end", "fields", "_rf")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        self.fields: Optional[Dict] = None

    def __enter__(self) -> "Span":
        open_ = self.tracer._open
        self.parent = open_[-1] if open_ else None
        open_.append(self.name)
        self._rf = None
        if _profiler_enabled():
            self._rf = RecordFunction(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.tracer._open.pop()
        self.tracer.spans.append((self.name, self.start, self.end, self.parent, self.fields))

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Tracer:
    """The host spans of one owner (a controller, or a trainer of its own)
    in a ring of the last ``capacity``, each ``(name, start_ns, end_ns,
    parent name, fields)`` on ``perf_counter_ns``, and the offset of
    ``device``'s stamps from that clock (``clock_offset_ns``).  With no
    profiler active a span costs two clock reads and one tuple append."""

    def __init__(self, device="cpu", capacity: int = 4096):
        self.device = torch.device(device)
        self.spans: Deque[Tuple] = collections.deque(maxlen=capacity)
        self._open: List[str] = []
        self.offset_ns = clock_offset_ns(self.device)

    def span(self, name: str) -> Span:
        return Span(self, name)

    def host_ns(self, stamp_ns: int) -> int:
        """A stamp of ``device`` on the spans' clock."""
        return stamp_ns - self.offset_ns

    def write(self, path: str, stamps: Sequence[Tuple[str, int]] = ()) -> str:
        """The ring as JSON lines at ``path``: a first line naming the clock
        and the device's offset, then one line per span, then one per
        ``(name, device stamp)`` of ``stamps``, placed on the host clock."""
        with open(path, "w") as f:
            f.write(json.dumps({"clock": "perf_counter_ns", "device": str(self.device),
                                "device_offset_ns": self.offset_ns}) + "\n")
            for name, start, end, parent, fields in self.spans:
                line = {"span": name, "start_ns": start, "end_ns": end, "parent": parent}
                if fields:
                    line["fields"] = fields
                f.write(json.dumps(line, default=str) + "\n")
            for name, t in stamps:
                f.write(json.dumps({"stamp": name, "host_ns": self.host_ns(t)}) + "\n")
        return path
