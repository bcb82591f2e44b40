"""Background renderer for plots and npz artifacts (a copy of
``pdecontrol_tpu.utils.asyncviz``, plain Python).

The host-side work of an evaluation (matplotlib rendering and compressed
npz writes) does not feed back into training, so it is submitted to ONE
worker thread here and overlaps the following iterations: the main thread
spends much of its time waiting on the device with the interpreter lock
released, which is when the worker can render.  The controller copies the
tensors a job needs to host memory before it queues the job, because the
replay and the modules are updated in place.

A single worker also serialises all matplotlib use in the training process
(``viz/plots.py`` uses the pyplot API, which is not safe across concurrent
threads).

Jobs are exception-guarded: a failed render (matplotlib missing, a full
disk) prints a warning and never kills training.

``enabled=False`` drops every job: a rank other than the primary of a
multi-process run writes no files (``parallel/distributed.py``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List


class BackgroundRenderer:
    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="viz")
        self._pending: List = []

    def submit(self, fn: Callable[[], None]) -> None:
        """Queue a no-arg job; capture loop state (iteration numbers,
        arrays) by value in the closure before submitting."""
        if not self.enabled:
            return

        def guarded() -> None:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — must never kill training
                print(f"[viz] background render failed: {e!r}", flush=True)

        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._pool.submit(guarded))

    def drain(self) -> None:
        """Block until every submitted job has finished (jobs swallow their
        own exceptions).  Called before anything that expects the artifact
        files on disk — end of learn(), test assertions."""
        for f in self._pending:
            f.result()
        self._pending.clear()
