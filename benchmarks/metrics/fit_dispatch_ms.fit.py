"""The untraced window's ``t_fit_dispatch`` (host time to launch the fit's
step and validation replays, per retrain) over its lock-step steps, in ms
per step."""


def read(ctx):
    steps = sum(r.get("steps", 0) for r in ctx["window"])
    return 1e3 * sum(r["t_fit_dispatch"] for r in ctx["window"]) / steps if steps else None
