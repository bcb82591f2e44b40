"""Median over the untraced window's records of ``t_dev_imagine``: the card's time
in the imagined-rollout phase (the world model's starts and steps and
the policy's action passes) of each replay of the fused iteration, between the device stamps
the replay writes, in ms."""

from benchmarks.harness.spans import median_ms


def read(ctx):
    return median_ms(ctx["window"], "t_dev_imagine")
