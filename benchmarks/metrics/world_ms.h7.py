"""ms per replay of the imagined-rollout phase graph (``ctl.imagine`` at the
cell's horizon: every round's starts and world steps and the policy's
action passes), by CUDA events around replays after the window."""

from benchmarks.harness.tracing import time_replays


def read(ctx):
    ctl, tr = ctx["ctl"], ctx["traffic"]
    if ctl.device.type != "cuda":
        return None
    return time_replays(lambda: ctl.imagine(int(tr["horizon"])), int(tr["layer_replays"]))
