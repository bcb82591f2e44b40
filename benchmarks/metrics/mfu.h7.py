"""Model FLOPs of the traced iterations, counted from shapes
(``counts/step.py``), over the traced span less the profiler's own gaps and
the float32 peak (the port runs float32 with TF32 off), in %."""

from benchmarks.counts import peaks, step
from benchmarks.harness.tracing import own_span_s


def read(ctx):
    t = ctx.get("trace")
    if not t or not ctx["traced"] or own_span_s(t) <= 0:
        return None
    flops = len(ctx["traced"]) * step.iteration(ctx["ctl"], int(ctx["traffic"]["horizon"]))
    return 100.0 * flops / (own_span_s(t) * peaks.FP32_FLOPS)
