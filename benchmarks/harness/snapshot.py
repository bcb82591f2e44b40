"""Copies of the program's state for the comparison after the window.

``loop`` and ``fit`` name the live tensors of a state, in nested dicts and
lists; ``Pinned`` holds host buffers for one such structure, allocated
during set-up, and ``Pinned.take`` queues the copies behind the work
before them without a host wait, so that a copy taken inside the window
neither stalls the loop nor adds to the device's memory."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def replay(rp) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(rp, f.name) for f in dataclasses.fields(rp)}


def adam(opt: torch.optim.Optimizer, params) -> Dict:
    """Each parameter's Adam state; one that has not stepped holds zeros."""
    def state(p):
        s = opt.state.get(p) or {}
        return {"step": s.get("step", torch.zeros((), device=p.device)),
                "exp_avg": s.get("exp_avg", torch.zeros_like(p)),
                "exp_avg_sq": s.get("exp_avg_sq", torch.zeros_like(p))}
    states = [state(p) for p in params]
    return {k: [s[k] for s in states] for k in ("step", "exp_avg", "exp_avg_sq")}


def sac(state) -> Dict:
    policy = list(state.policy.parameters())
    critic = list(state.critic.parameters())
    return {"policy": [p.detach() for p in policy], "critic": [p.detach() for p in critic],
            "target": [p.detach() for p in state.target.parameters()],
            "policy_opt": adam(state.policy_opt, policy),
            "critic_opt": adam(state.critic_opt, critic)}


def loop(ctl) -> Dict:
    """What one iteration of the MBPO loop reads and writes."""
    return {"u": ctl.env_state.u, "step": ctl.env_state.step, "pool": ctl.pool,
            "replay": replay(ctl.replay), "world_replay": replay(ctl.world_replay),
            "ens_params": ctl.ensemble.params.detach(), "elite": ctl.ensemble.elite_mask,
            "sac": sac(ctl.sac_state)}


def fit(fs) -> Dict[str, torch.Tensor]:
    return {"params": fs.params, "exp_avg": fs.exp_avg, "exp_avg_sq": fs.exp_avg_sq,
            "count": fs.count}


def tree_map(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [tree_map(fn, v) for v in obj]
    return obj


def _pairs(dst, src):
    if isinstance(dst, torch.Tensor):
        yield dst, src
    elif isinstance(dst, dict):
        for k in dst:
            yield from _pairs(dst[k], src[k])
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            yield from _pairs(a, b)


class Pinned:
    """Host buffers shaped like ``live``; on the CPU plain copies."""

    def __init__(self, live):
        pin = any(t.is_cuda for _, t in _pairs(live, live))
        self.data = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin), live)

    def take(self, live):
        for dst, src in _pairs(self.data, live):
            dst.copy_(src, non_blocking=True)
        return self.data


def copy(live):
    """A plain copy, with a host wait (for set-up)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), live)


def to(obj, device):
    return tree_map(lambda t: t.to(device), obj)
