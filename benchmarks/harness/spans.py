"""What the program's own tracing (``pdecontrol_tpu_torch/utils/profiling.py``)
recorded in the untraced part of a window, for the ``program_span`` readers.

The fused iteration's records carry their device stamps (``t_dev_*``), so
the h7 readers read ``ctx["window"]`` alone.  The retrain window
(``drivers/retrain.py``) keeps only a few fields of each retrain's logs in
its records; the whole logs ride on the ``retrain`` span in the
controller's ring of host spans, and ``window_fits`` finds the window's
among them.  A program without that
tracing has neither, and the readers return None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

# The window record's fields that identify its retrain among the spans.
_KEYS = ("steps", "epochs", "t_fit_dispatch", "t_fit_total")


def median_ms(records: List[Dict], field: str) -> Optional[float]:
    """The median of ``field`` (seconds) over the records that carry it, in
    ms."""
    values = [r[field] for r in records if field in r]
    return 1e3 * statistics.median(values) if values else None


def window_fits(ctx: Dict) -> Optional[List[Dict]]:
    """The logs of the window's retrains, from the ``retrain`` spans of the
    controller's tracer: the last run of consecutive spans whose logs agree
    with the window's records field by field.  None where the program keeps
    no such spans or they do not match."""
    window = ctx.get("window") or []
    tracer = getattr(ctx.get("ctl"), "tracer", None)
    if not window or tracer is None:
        return None
    fits = [span[4] for span in tracer.spans if span[0] == "retrain" and span[4]]
    want = [tuple(r.get(k) for k in _KEYS) for r in window]
    for i in range(len(fits) - len(want), -1, -1):
        got = [tuple(f.get(k) for k in _KEYS) for f in fits[i: i + len(want)]]
        if got == want:
            return fits[i: i + len(want)]
    return None


def per_step_ms(ctx: Dict, field: str) -> Optional[float]:
    """``field`` (seconds) summed over the window's retrains, over their
    lock-step steps, in ms per step."""
    fits = window_fits(ctx)
    if not fits or any(field not in f for f in fits):
        return None
    steps = sum(f["steps"] for f in fits)
    return 1e3 * sum(f[field] for f in fits) / steps if steps else None
