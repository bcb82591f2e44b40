"""K1's share of its roofline over the traced span: its launches' least time
(``counts/k1.py``, at the cell's batch of envs) over its device time by
kernel name in the trace, in %."""

from benchmarks.counts import k1


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    names = [n for n in trace["kernels"] if k1.is_k1(n)]
    seconds = sum(trace["kernels"][n] for n in names)
    launches = sum(trace["kernel_counts"][n] for n in names)
    if not launches or seconds <= 0:
        return None
    env = ctx["ctl"].env
    return 100.0 * launches * k1.bound_s(ctx["ctl"].config.num_envs, env.n, env.cfg_steps) / seconds
