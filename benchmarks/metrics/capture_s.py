"""Seconds the set-up spent capturing CUDA graphs: its records' ``t_capture``
(the fused iteration) and ``t_fit_capture`` (the fit's step and validation
step)."""


def read(ctx):
    s = sum(r.get("t_capture", 0.0) + r.get("t_fit_capture", 0.0) for r in ctx["setup"])
    return float(s) if s else None
