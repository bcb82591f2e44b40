"""Plain surrogate retrain (the ECC'24 reference's ``mbrl/mbrl.py:568-602`` and
``surrogates/training.py``), as lock-step calls of a few TBPTT steps and
one validation step each.

A retrain refits the delta scaling over the whole replay, splits the
replay's episodes into train and validation rows (a shuffle seeded by the
iteration; ``val_split_ratio`` of the rows, among those long enough for a
window, validate), and trains every member on its own batch of windows of
``tau + K`` frames: the loss is the MSE of the scaled per-step deltas
(AUTOREG) or of the decoded states (LATENT), the rollout teacher-forced
over ``tau`` frames and re-encoding its own detached output at every TBPTT
chunk boundary (``t >= tbtt`` and ``t % tbtt == 0``).  The step is optax's
Adam (beta 0.9, 0.999, eps 1e-8 outside the root, the learning rate times
the bias-corrected ratio) on each member's whole gradient.  Validation runs
every member free after ``tau`` frames on its own batch of validation
windows, without re-encoding, and scores the MSE of the unscaled states.
The train batches of all members are drawn as one draw, then the
validation batches as another.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmarks.reference import replay as R
from benchmarks.reference import surrogate as S
from benchmarks.reference.mbpo import scale, unscale

B1, B2, EPS = 0.9, 0.999, 1e-8


def split(fill: np.ndarray, iteration: int, val_ratio: float, length: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Boolean train and validation row masks."""
    rows = np.where(fill > 0)[0]
    np.random.default_rng(iteration).shuffle(rows)
    ok, short = rows[fill[rows] >= length], rows[fill[rows] < length]
    if len(ok) == 1:
        val, train = ok, np.concatenate([ok, short])
    else:
        n_val = min(max(int(len(rows) * val_ratio), 1), len(ok) - 1)
        val, train = ok[:n_val], np.concatenate([ok[n_val:], short])
    train_np = np.zeros(fill.shape[0], bool)
    val_np = np.zeros(fill.shape[0], bool)
    train_np[train] = True
    val_np[val] = True
    return train_np, val_np


def reencode_steps(t_total: int, tbtt: int) -> np.ndarray:
    t = np.arange(t_total)
    return (t >= tbtt) & (t % tbtt == 0)


def member_loss(p, mode: str, states, actions, delta: float, d_mean, d_std, tau: int,
                tbtt: int) -> torch.Tensor:
    outputs, deltas, _ = S.rollout(p, mode, states[:, :tau], actions, delta, d_mean, d_std,
                                   reencode=reencode_steps(actions.shape[1], tbtt))
    if mode == S.AUTOREG:
        target = (torch.diff(states, dim=1) / delta - d_mean) / d_std
        return torch.mean((deltas[:, :-1] - target) ** 2)
    decoded = torch.cat([states[:, :1], outputs[:, :-1]], dim=1)
    return torch.mean((decoded - states) ** 2)


def member_val(p, mode: str, states, actions, delta: float, d_mean, d_std, tau: int,
               vmin, vmax) -> torch.Tensor:
    outputs, _, _ = S.rollout(p, mode, states[:, :tau], actions, delta, d_mean, d_std)
    decoded = torch.cat([states[:, :1], outputs[:, :-1]], dim=1)
    return torch.mean((unscale(decoded, vmin, vmax) - unscale(states, vmin, vmax)) ** 2)


def batches(rp: R.Replay, gen, m: int, bs: int, length: int, mask, vmin, vmax, world_action):
    w = R.windows(rp, gen, m * bs, length, mask)
    obs = scale(w["obs"], vmin, vmax)
    act = world_action(w["actions"])
    return (obs.reshape((m, bs) + tuple(obs.shape[1:])),
            act.reshape((m, bs) + tuple(act.shape[1:])))


def epoch_steps(fill: np.ndarray, train_np: np.ndarray, length: int, batch_size: int) -> int:
    """Steps of one epoch: the train rows' non-overlapping windows over the
    batch size (``SubSeqDataset``'s stride equals the window)."""
    nwin = int(np.sum(np.maximum((fill[train_np] - length) // length + 1, 0)))
    return max(nwin // batch_size, 1)


def lockstep_call(st: Dict, rp: R.Replay, train_mask, val_mask, gen, cfg: Dict,
                  world_action, steps: int = 1) -> Dict[str, torch.Tensor]:
    """``steps`` TBPTT steps of every member, then one validation step, in
    place on ``st`` (``params`` [M, P], ``exp_avg``, ``exp_avg_sq``,
    ``count`` [M]).  Returns each member's loss at the last step and
    gradient at the first, and each member's val loss."""
    m, n = st["params"].shape[0], cfg["n"]
    length, bs, mode, delta = cfg["length"], cfg["batch_size"], cfg["mode"], cfg["delta"]
    vmin, vmax, d_mean, d_std = st["vmin"], st["vmax"], st["d_mean"], st["d_std"]
    first = None
    for _ in range(steps):
        obs, act = batches(rp, gen, m, bs, length, train_mask, vmin, vmax, world_action)
        losses, grads = [], []
        for i in range(m):
            flat = st["params"][i].detach().clone().requires_grad_(True)
            loss = member_loss(S.unflatten(flat, n), mode, obs[i], act[i], delta, d_mean,
                               d_std, cfg["tau"], cfg["tbtt"])
            (g,) = torch.autograd.grad(loss, flat)
            losses.append(loss.detach())
            grads.append(g)
        g = torch.stack(grads)
        first = g if first is None else first
        with torch.no_grad():
            count = st["count"] + 1
            mu = (1 - B1) * g + B1 * st["exp_avg"]
            nu = (1 - B2) * g * g + B2 * st["exp_avg_sq"]
            t = count.to(g.dtype)[:, None]
            upd = (mu / (1 - B1 ** t)) / (torch.sqrt(nu / (1 - B2 ** t)) + EPS)
            st["params"] = st["params"] - cfg["lr"] * upd
            st["exp_avg"], st["exp_avg_sq"], st["count"] = mu, nu, count
    with torch.no_grad():
        obs, act = batches(rp, gen, m, bs, length, val_mask, vmin, vmax, world_action)
        val = torch.stack([member_val(S.unflatten(st["params"][i], n), mode, obs[i], act[i],
                                      delta, d_mean, d_std, cfg["tau"], vmin, vmax)
                           for i in range(m)])
    return {"loss": torch.stack(losses), "grad": first, "val": val}
