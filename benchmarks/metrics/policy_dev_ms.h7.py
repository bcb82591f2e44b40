"""Median over the untraced window's records of ``t_dev_policy``: the card's time
in the SAC phase (the iteration's updates on mixed batches) of each replay of the fused iteration, between the device stamps
the replay writes, in ms."""

from benchmarks.harness.spans import median_ms


def read(ctx):
    return median_ms(ctx["window"], "t_dev_policy")
