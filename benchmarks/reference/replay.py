"""Plain episodic replay: the draws and the writes of the MBPO loop.

A replay is a dict of tensors: ``obs_seq`` [E, T+1, C, H] (frame ``t`` is
the observation before step ``t``, frame ``t+1`` the one after it),
``actions`` [E, T, ...], ``rewards``, ``terminated``, ``truncated`` and
``steps`` [E, T], ``fill`` [E] (steps written in each row), ``complete``
[E], ``row_of_env`` [N] (the row each env writes), ``next_row`` and
``total_steps`` (scalars).  Rows are whole episodes, claimed in a ring.

The draws are those of the ECC'24 reference's datasets: a window is drawn
uniformly over every stride-1 window of every row (``SubSeqDataset`` with
bootstrapping), a starting window over every length-``tau`` window and
every shorter prefix at an episode's start, left padded with its first
frame (``StartingStateDataset``).  A row is drawn in proportion to its
count of windows by inverting the counts' int64 cumulative sum at a
float64 uniform, then a start within it by a float32 uniform, in that
order; a generator in a given state gives the same windows to any program
that draws them so.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Replay = Dict[str, torch.Tensor]


def draw_rows(counts: torch.Tensor, batch: int, gen) -> torch.Tensor:
    counts = counts.to(torch.int64)
    if int(counts.sum()) == 0:
        counts = torch.ones_like(counts)
    cdf = torch.cumsum(counts, 0)
    u = torch.rand((batch,), generator=gen, dtype=torch.float64, device=counts.device)
    target = torch.minimum(torch.floor(u * cdf[-1]).to(torch.int64), cdf[-1] - 1)
    return torch.searchsorted(cdf, target, right=True)


def gather(rp: Replay, rows: torch.Tensor, starts: torch.Tensor, length: int) -> Replay:
    t = torch.clamp(starts[:, None] + torch.arange(length, device=rows.device)[None, :], min=0)
    r = rows[:, None]
    return {"obs": rp["obs_seq"][r, t], "nxtobs": rp["obs_seq"][r, t + 1],
            "actions": rp["actions"][r, t], "rewards": rp["rewards"][r, t],
            "terminated": rp["terminated"][r, t], "truncated": rp["truncated"][r, t],
            "steps": rp["steps"][r, t]}


def windows(rp: Replay, gen, batch: int, length: int,
            rows_mask: Optional[torch.Tensor] = None) -> Replay:
    counts = torch.clamp(rp["fill"].to(torch.int64) - length + 1, min=0)
    if rows_mask is not None:
        counts = counts * rows_mask.to(torch.int64)
    rows = draw_rows(counts, batch, gen)
    max_start = torch.clamp(rp["fill"][rows].to(torch.int64) - length, min=0)
    u = torch.rand((batch,), generator=gen, device=rows.device)
    starts = torch.floor(u * (max_start + 1).to(torch.float32)).to(torch.int64)
    return gather(rp, rows, starts, length)


def transitions(rp: Replay, gen, batch: int) -> Replay:
    return {k: v[:, 0] for k, v in windows(rp, gen, batch, 1).items()}


def starting_windows(rp: Replay, gen, batch: int, tau: int) -> Replay:
    fill = rp["fill"].to(torch.int64)
    counts = torch.clamp(fill - tau + 1, min=0) + torch.clamp(fill, max=tau - 1)
    rows = draw_rows(counts, batch, gen)
    lo = -torch.clamp(fill[rows], max=tau - 1)
    hi = torch.clamp(fill[rows] - tau, min=0)
    u = torch.rand((batch,), generator=gen, device=rows.device)
    starts = lo + torch.floor(u * (hi - lo + 1).to(torch.float32)).to(torch.int64)
    return gather(rp, rows, starts, tau)


def write(rp: Replay, obs, actions, rewards, terminated, truncated, nxtobs, steps) -> None:
    """One step of every env, in place; an env whose episode ended claims
    the next row of the ring, whose old contents are dropped."""
    e = rp["obs_seq"].shape[0]
    rows = rp["row_of_env"] % e
    cols = rp["fill"][rows].to(torch.int64)
    rp["obs_seq"][rows, cols] = obs.to(rp["obs_seq"].dtype)
    rp["obs_seq"][rows, cols + 1] = nxtobs.to(rp["obs_seq"].dtype)
    rp["actions"][rows, cols] = actions.to(rp["actions"].dtype)
    rp["rewards"][rows, cols] = rewards.to(rp["rewards"].dtype)
    rp["terminated"][rows, cols] = terminated
    rp["truncated"][rows, cols] = truncated
    rp["steps"][rows, cols] = steps.to(rp["steps"].dtype)
    done = terminated | truncated
    rp["fill"][rows] = (cols + 1).to(rp["fill"].dtype)
    rp["complete"][rows] = done
    rp["total_steps"] += obs.shape[0]
    done_i = done.to(torch.int64)
    new_rows = rp["next_row"] + torch.cumsum(done_i, 0) - 1
    rp["row_of_env"] = torch.where(done, new_rows, rp["row_of_env"])
    rp["next_row"] = rp["next_row"] + done_i.sum()
    claimed = torch.zeros(e, dtype=torch.bool, device=done.device)
    claimed[(new_rows % e)[done]] = True
    rp["fill"] = rp["fill"].masked_fill(claimed, 0)
    rp["complete"] = rp["complete"].masked_fill(claimed, False)
