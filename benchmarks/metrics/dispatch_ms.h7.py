"""Mean of the untraced window's records' ``t_dispatch`` (the controller's
host time to launch an iteration's replay and queue its record's copy), in
ms."""


def read(ctx):
    d = [r["t_dispatch"] for r in ctx["window"] if "t_dispatch" in r]
    return 1e3 * sum(d) / len(d) if d else None
