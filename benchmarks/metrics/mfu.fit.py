"""Model FLOPs of the traced retrain's lock-step steps and validation
passes, counted from shapes (``counts/step.py``), over the traced span less
the profiler's own gaps and the float32 peak (the port runs float32 with
TF32 off), in %."""

from benchmarks.counts import peaks, step
from benchmarks.harness.tracing import own_span_s


def read(ctx):
    t = ctx.get("trace")
    if not t or not ctx["traced"] or own_span_s(t) <= 0:
        return None
    per = step.fit(ctx["ctl"])
    flops = sum(r["steps"] * per["step"] + r["epochs"] * per["val"] for r in ctx["traced"])
    return 100.0 * flops / (own_span_s(t) * peaks.FP32_FLOPS)
