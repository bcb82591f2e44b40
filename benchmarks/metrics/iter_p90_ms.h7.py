"""90th percentile of the wall time between consecutive iterations of the
untraced window (host clock, all iterations), in ms."""

import numpy as np


def read(ctx):
    walls = ctx.get("walls")
    return float(np.percentile(walls, 90)) * 1e3 if walls else None
