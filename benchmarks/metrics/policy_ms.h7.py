"""ms per replay of the SAC phase graph (``ctl.update_policy``: the chained
updates on mixed batches), by CUDA events around replays after the
window."""

from benchmarks.harness.tracing import time_replays


def read(ctx):
    ctl = ctx["ctl"]
    if ctl.device.type != "cuda":
        return None
    return time_replays(ctl.update_policy, int(ctx["traffic"]["layer_replays"]))
