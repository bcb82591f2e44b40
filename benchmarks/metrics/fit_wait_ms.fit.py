"""The card's time outside the fit's step and validation replays between each
retrain's first and last stamp (``t_fit_dev_wait``: within the epochs and
across their pulls) summed over the untraced window's retrains, over their
lock-step steps, in ms per step."""

from benchmarks.harness.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "t_fit_dev_wait")
