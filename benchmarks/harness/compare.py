"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference computes, each held to a limit."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def max_gap(prog: torch.Tensor, ref: torch.Tensor, scale: Optional[torch.Tensor] = None) -> float:
    """The largest absolute difference over the largest magnitude of
    ``scale`` (by default of ``ref``)."""
    prog, ref = prog.double(), ref.double()
    denom = float((ref if scale is None else scale.double()).abs().max())
    return float((prog - ref).abs().max()) / max(denom, 1e-30)


def leaf_gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
              keep: Optional[Sequence[bool]] = None) -> List[float]:
    """Each kept leaf's gap between the program's and the reference's norm,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = sorted(rn)[len(rn) // 2]
    return [abs(a - b) / max(b, med, 1e-30)
            for i, (a, b) in enumerate(zip(pn, rn)) if keep is None or keep[i]]


def leaf_gap(prog, ref, keep=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    gaps = leaf_gaps(prog, ref, keep)
    return max(gaps) if gaps else math.nan


def median_leaf_gap(prog, ref, keep=None) -> float:
    """The median leaf's gap (``leaf_gaps``)."""
    gaps = sorted(leaf_gaps(prog, ref, keep))
    return gaps[len(gaps) // 2] if gaps else math.nan


def moving_leaves(grads: Sequence[torch.Tensor]) -> List[bool]:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others (a bias that a norm or a softmax cancels)
    move under Adam by round-off alone."""
    norms = [float(torch.linalg.vector_norm(g.double())) for g in grads]
    med = sorted(norms)[len(norms) // 2]
    return [n > 1e-3 * med for n in norms]


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` and each number beside its limit.  A number without a
    limit, or not finite, is not correct."""
    checks, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok and bool(values), checks
