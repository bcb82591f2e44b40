"""Median over the untraced window's records of ``t_dev_wait``: the card's
time from one replay of the fused iteration's last stamp to the next
replay's first (the previous record's packing and pull, and any wait for the
host to launch the next replay), in ms."""

from benchmarks.harness.spans import median_ms


def read(ctx):
    return median_ms(ctx["window"], "t_dev_wait")
