"""The card's time in the lock-step fit's step replays (``t_fit_dev_step``,
between the stamps inside the step's graph) summed over the untraced
window's retrains, over their lock-step steps, in ms per step."""

from benchmarks.harness.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "t_fit_dev_step")
