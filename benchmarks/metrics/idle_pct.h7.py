"""Share of the traced span in which no kernel, copy or set ran on the
device, in %, leaving out the gaps under the profiler's own host events
(its buffer flushes), which an untraced run does not have."""

from benchmarks.harness.tracing import own_span_s


def read(ctx):
    t = ctx.get("trace")
    if not t or t["busy_s"] <= 0 or own_span_s(t) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / own_span_s(t))
