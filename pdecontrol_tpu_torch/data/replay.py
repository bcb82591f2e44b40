"""Episodic experience replay in device memory (port of
``pdecontrol_tpu/data/replay.py``).

Episodes are rows of dense ``[num_rows, ep_len, ...]`` tensors with a per-row
fill counter, so writing one vectorised env step, sampling windows for the
surrogate and sampling transitions for SAC are all gathers and scatters on
the device.  KS episodes are truncation-only and fixed-length, which makes
the layout exact; imagined rollouts use a second instance with ``ep_len`` =
the largest horizon.  Eviction is a ring over whole episode rows (FIFO, as
the reference's ``replay.resize``, replay.py:98-110).

``obs_seq`` holds ``ep_len + 1`` frames per row: frame ``t`` is the obs
before step ``t`` and frame ``t+1`` the obs after it, so ``nxtobs`` is a
shifted view and terminal observations need no separate channel.

Unlike the JAX package, ``write_step`` updates the replay *in place* (it
returns the same object, every field at its address): the buffers are the
largest tensors of a run, copying them on every env step would only cost
memory traffic, and a CUDA graph of the loop reads and writes fixed
addresses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pdecontrol_tpu_torch.data.types import Sample


@dataclasses.dataclass
class ReplayState:
    obs_seq: torch.Tensor  # [E, T+1, C, H]
    actions: torch.Tensor  # [E, T, Ca, A]
    rewards: torch.Tensor  # [E, T]
    terminated: torch.Tensor  # [E, T] bool
    truncated: torch.Tensor  # [E, T] bool
    steps: torch.Tensor  # [E, T] int32 (env step counter as reported in infos)
    fill: torch.Tensor  # [E] int32 — timesteps written in each row
    complete: torch.Tensor  # [E] bool — episode finished (terminated | truncated)
    row_of_env: torch.Tensor  # [N] int64 — row each live sub-env writes to
    next_row: torch.Tensor  # int64 — ring allocation cursor (monotone; row = mod E)
    total_steps: torch.Tensor  # int64 — total timesteps ever written

    @property
    def num_rows(self) -> int:
        return self.obs_seq.shape[0]

    @property
    def ep_len(self) -> int:
        return self.actions.shape[1]

    @property
    def num_envs(self) -> int:
        return self.row_of_env.shape[0]

    @property
    def ntimesteps(self) -> torch.Tensor:
        return torch.sum(self.fill)

    @property
    def ncomplete(self) -> torch.Tensor:
        return torch.sum(self.complete.to(torch.int32))


def create(
    num_rows: int,
    ep_len: int,
    num_envs: int,
    obs_shape: Tuple[int, int],
    action_shape: Tuple[int, int],
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> ReplayState:
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return ReplayState(
        obs_seq=z((num_rows, ep_len + 1) + tuple(obs_shape), dtype),
        actions=z((num_rows, ep_len) + tuple(action_shape), dtype),
        rewards=z((num_rows, ep_len), dtype),
        terminated=z((num_rows, ep_len), torch.bool),
        truncated=z((num_rows, ep_len), torch.bool),
        steps=z((num_rows, ep_len), torch.int32),
        fill=z((num_rows,), torch.int32),
        complete=z((num_rows,), torch.bool),
        row_of_env=torch.arange(num_envs, device=device),
        next_row=torch.tensor(num_envs, device=device),
        total_steps=z((), torch.int64),
    )


def write_step(
    replay: ReplayState,
    obs: torch.Tensor,  # [N, C, H] obs *before* the step (raw / pre-transform)
    actions: torch.Tensor,  # [N, Ca, A] raw env-space actions
    rewards: torch.Tensor,  # [N]
    terminated: torch.Tensor,  # [N] bool
    truncated: torch.Tensor,  # [N] bool
    nxtobs: torch.Tensor,  # [N, C, H] obs *after* the step (terminal obs if done)
    steps: torch.Tensor,  # [N] int step counter from the env info
) -> ReplayState:
    """Record one vectorised env transition (in place); advance rows on
    episode end.  Raw (pre-transform) values are stored, and transforms
    apply at sampling time (reference worker.py:68-84)."""
    rows = replay.row_of_env % replay.num_rows
    cols = replay.fill[rows].long()

    replay.obs_seq[rows, cols] = obs.to(replay.obs_seq.dtype)
    replay.obs_seq[rows, cols + 1] = nxtobs.to(replay.obs_seq.dtype)
    replay.actions[rows, cols] = actions.to(replay.actions.dtype)
    replay.rewards[rows, cols] = rewards.to(replay.rewards.dtype)
    replay.terminated[rows, cols] = terminated
    replay.truncated[rows, cols] = truncated
    replay.steps[rows, cols] = steps.to(replay.steps.dtype)
    done = terminated | truncated
    replay.fill[rows] = (cols + 1).to(replay.fill.dtype)
    replay.complete[rows] = done
    replay.total_steps += obs.shape[0]

    # Allocate fresh rows for envs whose episode just ended (ring FIFO) and
    # wipe the fill/complete flags of the rows they claim.  Only done envs
    # mark a row: the others scatter into a spare slot past the end, so a
    # not-done env can never clear a freshly claimed row (and no
    # data-dependent shape forces a device sync).
    done_i = done.to(torch.int64)
    new_rows = replay.next_row + torch.cumsum(done_i, 0) - 1
    replay.row_of_env.copy_(torch.where(done, new_rows, replay.row_of_env))
    replay.next_row.add_(done_i.sum())
    e = replay.num_rows
    claimed = torch.zeros(e + 1, dtype=torch.bool, device=done.device)
    claimed.index_fill_(0, torch.where(done, new_rows % e, e), True)
    claimed = claimed[:e]
    replay.fill.masked_fill_(claimed, 0)
    replay.complete.masked_fill_(claimed, False)
    return replay


def _gather_window(replay: ReplayState, rows: torch.Tensor, starts: torch.Tensor,
                   length: int) -> Sample:
    """Gather [B, length, ...] windows; ``starts`` may be negative — indices
    clamp to 0, reproducing the repeat-first-element left padding of
    ``PDEDataLoader.padding_collate`` (dataset.py:190-205)."""
    ar = torch.arange(length, device=rows.device)
    t_idx = torch.clamp(starts[:, None] + ar[None, :], min=0)
    r = rows[:, None]
    return Sample(
        obs=replay.obs_seq[r, t_idx],
        actions=replay.actions[r, t_idx],
        nxtobs=replay.obs_seq[r, t_idx + 1],
        rewards=replay.rewards[r, t_idx],
        terminated=replay.terminated[r, t_idx],
        truncated=replay.truncated[r, t_idx],
        steps=replay.steps[r, t_idx],
    )


def _row_weights(replay: ReplayState, length: int,
                 rows_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of stride-1 windows of ``length`` per row (0 if too short)."""
    w = torch.clamp(replay.fill - length + 1, min=0).to(torch.float32)
    if rows_mask is not None:
        w = w * rows_mask.to(torch.float32)
    return w


def _categorical(weights: torch.Tensor, batch: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``batch`` row draws with probability proportional to ``weights``.
    All-zero weights (guarded against by the trainer) draw uniformly, as the
    JAX package's ``log(w + 1e-30)`` logits do."""
    w = weights + 1e-30
    return torch.multinomial(w, batch, replacement=True, generator=generator)


def sample_windows(
    replay: ReplayState,
    generator: Optional[torch.Generator],
    batch: int,
    length: int,
    rows_mask: Optional[torch.Tensor] = None,
) -> Sample:
    """Bootstrap-sample [B, L, ...] subsequence windows, uniform over all
    stride-1 windows across episodes — the sampling distribution of
    ``SubSeqDataset`` with ``bootstrapping=True`` (dataset.py:59-79).
    ``rows_mask`` restricts to an episode subset (train/val split)."""
    rows = _categorical(_row_weights(replay, length, rows_mask), batch, generator)
    max_start = torch.clamp(replay.fill[rows] - length, min=0)
    u = torch.rand((batch,), generator=generator, device=rows.device)
    starts = torch.floor(u * (max_start + 1).to(torch.float32)).to(torch.int64)
    return _gather_window(replay, rows, starts, length)


def enumerate_windows(
    replay: ReplayState,
    length: int,
    stride: Optional[int] = None,
    rows_mask: Optional[torch.Tensor] = None,
) -> Sample:
    """Every strided window, deterministically ordered — the reference's
    non-bootstrap ``SubSeqDataset`` enumeration (dataset.py:54-76; window
    ``i`` of a row starts at ``i * stride``).  ``stride=None`` means
    non-overlapping windows (``stride=length``)."""
    stride = length if stride is None else stride
    fill = replay.fill.cpu().numpy()
    if rows_mask is None:
        mask = np.ones_like(fill, dtype=bool)
    else:
        mask = rows_mask.cpu().numpy().astype(bool)
    rows_l, starts_l = [], []
    for r in np.nonzero(mask)[0]:
        n = max((int(fill[r]) - length) // stride + 1, 0)
        rows_l.extend([r] * n)
        starts_l.extend(i * stride for i in range(n))
    dev = replay.fill.device
    rows = torch.as_tensor(np.asarray(rows_l, np.int64), device=dev)
    starts = torch.as_tensor(np.asarray(starts_l, np.int64), device=dev)
    return _gather_window(replay, rows, starts, length)


def sample_starting(
    replay: ReplayState, generator: Optional[torch.Generator], batch: int, tau: int
) -> Sample:
    """Warmup windows for the world env: length-``tau`` windows anywhere in
    an episode PLUS shorter prefixes at episode starts, left-padded by
    repeating the first frame — the ``StartingStateDataset`` semantics
    (dataset.py:119-160).  Negative starts implement the short prefixes."""
    # Rows weighted by number of admissible starts: fill windows + (tau - 1)
    # prefix windows (lengths 1..tau-1), matching the concat dataset sizes.
    w = torch.clamp(replay.fill - tau + 1, min=0) + torch.clamp(replay.fill, max=tau - 1)
    rows = _categorical(w.to(torch.float32), batch, generator)
    lo = -torch.clamp(replay.fill[rows], max=tau - 1)
    hi = torch.clamp(replay.fill[rows] - tau, min=0)
    u = torch.rand((batch,), generator=generator, device=rows.device)
    starts = lo + torch.floor(u * (hi - lo + 1).to(torch.float32)).to(torch.int64)
    return _gather_window(replay, rows, starts, tau)


def sample_transitions(replay: ReplayState, generator: Optional[torch.Generator],
                       batch: int) -> Sample:
    """Uniform single transitions across all stored timesteps (the SAC batch
    source; reference SubSeqDataset(length=1) + RandomSampler,
    mbrl.py:531-552)."""
    sample = sample_windows(replay, generator, batch, length=1)
    return sample.apply(lambda x: x.squeeze(1))


def episode_returns(replay: ReplayState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean/std of summed rewards over completed episodes
    (reference ``statistics``, replay.py:112-117)."""
    mask = replay.complete.to(replay.rewards.dtype)
    ar = torch.arange(replay.ep_len, device=replay.fill.device)
    trange = ar[None, :] < replay.fill[:, None]
    returns = torch.sum(replay.rewards * trange, dim=1)
    n = torch.clamp(torch.sum(mask), min=1.0)
    mean = torch.sum(returns * mask) / n
    var = torch.sum(mask * (returns - mean) ** 2) / n
    return mean, torch.sqrt(var)


def delta_statistics(
    replay: ReplayState, otransf, delta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean/variance (ddof=1) of per-step obs deltas in transformed space
    over all valid timesteps — the ``update_delta_transform`` fit
    (mbrl.py:597-602: reset + one Welford update over the whole dataset,
    which equals plain batch statistics)."""
    obs = otransf.apply(replay.obs_seq[:, :-1])
    nxt = otransf.apply(replay.obs_seq[:, 1:])
    deltas = (nxt - obs) / delta
    ar = torch.arange(replay.ep_len, device=replay.fill.device)
    valid = (ar[None, :] < replay.fill[:, None]).to(deltas.dtype)[..., None, None]
    valid = torch.broadcast_to(valid, deltas.shape)
    n = torch.clamp(torch.sum(valid), min=1.0)
    mean = torch.sum(deltas * valid) / n
    var = torch.sum(valid * (deltas - mean) ** 2) / torch.clamp(n - 1.0, min=1.0)
    return mean, var
