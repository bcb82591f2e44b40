"""Plain MBPO iteration on the Kuramoto-Sivashinsky env (the ECC'24
reference's ``mbrl/mbrl.py:384-566``): what one iteration that does not
retrain computes, from the loop's state before it.

  1. collect: each env takes one step under the policy's sampled action
     (the agent sees the observation min/max-scaled to [-1, 1]; the env
     gets the action in its bounds, as the forcing field ``a @ F``); an env
     whose episode ends restarts from a reset-pool state; the running
     min/max of the observations takes the new and the final ones; the
     transition goes to the replay;
  2. imagine: ``rounds`` batches of imagined rollouts of ``horizon`` steps
     from starting windows of the replay: every member is teacher-forced
     over the window, then stepped on the previous selected output, and
     each row takes a random elite member's output; the reward is the
     env's objective on the unscaled output and forcing field; a fresh
     start is drawn at every step but a round's last, and taken when every
     row is done; the transitions go to the imagined replay;
  3. policy: chained SAC updates, each on a batch whose rows come from the
     imagined replay with probability ``imagined / (imagined + real)``
     transitions, else from the real one.

The draws come from one generator in the loop's order (per env step: the
action noise, then the reset indices; per imagined round: the starting
window, the members, then per step the action noise, the members and the
next fresh start; per update: the real rows, the imagined rows, the pick,
then the SAC noises).  State is a dict of tensors; ``iterate`` returns the
state after the iteration.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from benchmarks.reference import ks
from benchmarks.reference import replay as R
from benchmarks.reference import sac
from benchmarks.reference import surrogate as S


def scale(x, vmin, vmax, lower=-1.0, upper=1.0):
    return (x - vmin) / (vmax - vmin) * (upper - lower) + lower


def unscale(x, vmin, vmax, lower=-1.0, upper=1.0):
    return (x - lower) / (upper - lower) * (vmax - vmin) + vmin


def obs_scaling(rp: R.Replay, u: torch.Tensor):
    """The running min and max of every observation the envs have shown:
    each row's frames 0..fill and the envs' current fields (a ring that has
    not wrapped keeps them all)."""
    fill = rp["fill"].to(torch.int64)
    frames = torch.arange(rp["obs_seq"].shape[1], device=fill.device)
    valid = (frames[None, :] <= fill[:, None]) & (fill[:, None] > 0)
    vals = rp["obs_seq"][valid]
    vmin = torch.minimum(vals.min(), u.min()) if vals.numel() else u.min()
    vmax = torch.maximum(vals.max(), u.max()) if vals.numel() else u.max()
    return vmin, vmax


def delta_scaling(rp: R.Replay, vmin, vmax, delta: float):
    """Mean and standard deviation (variance with Bessel's correction, plus
    1e-4 under the root) of every stored step's scaled-observation delta
    over ``delta``, in float64."""
    obs = scale(rp["obs_seq"].double(), vmin.double(), vmax.double())
    d = torch.diff(obs, dim=1) / delta
    valid = torch.arange(d.shape[1], device=d.device)[None, :] < rp["fill"][:, None]
    vals = d[valid]
    n = max(vals.numel(), 1)
    mean = vals.sum() / n
    var = ((vals - mean) ** 2).sum() / max(n - 1, 1)
    return mean.float(), torch.sqrt(var + 1e-4).float()


class Iteration:
    """``cfg``: ``env`` (n, length, dt, cfg_steps, sigma, objective,
    max_episode_steps), ``horizon``, ``rounds``, ``world_batch``, ``tau``,
    ``mode``, ``delta``, ``updates``, ``policy_batch`` and the SAC keys
    (gamma, sac_tau, alpha, lr, reward_scale, target_update_interval)."""

    def __init__(self, cfg: Dict, device):
        self.cfg = cfg
        env = cfg["env"]
        self.F = ks.forcing_matrix(env["n"], env["length"], env["sigma"],
                                   dtype=torch.float32, device=device)
        f64 = ks.forcing_matrix(env["n"], env["length"], env["sigma"], device=device)
        lo, hi = -torch.ones(f64.shape[0], dtype=torch.float64, device=device) @ f64, \
            torch.ones(f64.shape[0], dtype=torch.float64, device=device) @ f64
        self.pmin = torch.minimum(lo, hi).min().float()
        self.pmax = torch.maximum(lo, hi).max().float()
        self.objective = ks.objective_of(env)

    # -------------------------------------------------------------- helpers
    def field(self, env_action):
        return env_action @ self.F

    def world_action(self, env_action):
        return scale(self.field(env_action), self.pmin, self.pmax)

    def period(self, u, phi):
        env = self.cfg["env"]
        u2, r = ks.control_period(u.double(), phi.double(), env["length"], env["dt"],
                                  env["cfg_steps"], self.objective)
        return u2.float(), r.float()

    def members(self, st):
        n = self.cfg["env"]["n"]
        return [S.unflatten(row, n) for row in st["ens_params"]]

    def rollout_all(self, st, states, actions, hidden=None):
        outs, hs, cs = [], [], []
        for m, p in enumerate(self.members(st)):
            h = None if hidden is None else (hidden[0][m], hidden[1][m])
            o, _, (hn, cn) = S.rollout(p, self.cfg["mode"], states, actions, self.cfg["delta"],
                                       st["d_mean"], st["d_std"], hidden=h)
            outs.append(o)
            hs.append(hn)
            cs.append(cn)
        return torch.stack(outs), (torch.stack(hs), torch.stack(cs))

    def select(self, st, gen, outputs):
        b = outputs.shape[1]
        idx = torch.multinomial(st["elite"].to(torch.float32), b, replacement=True, generator=gen)
        return outputs[idx, torch.arange(b, device=outputs.device)]

    def world_start(self, st, gen):
        w = R.starting_windows(st["replay"], gen, self.cfg["world_batch"], self.cfg["tau"])
        obs = scale(w["obs"], st["vmin"], st["vmax"])
        outs, hidden = self.rollout_all(st, obs, self.world_action(w["actions"]))
        return {"obs": self.select(st, gen, outs[:, :, -1]), "hidden": hidden,
                "t": w["steps"][:, -1].to(torch.int64),
                "sim": torch.zeros((), dtype=torch.int64, device=obs.device)}

    def act(self, st, gen, agent_obs):
        noise = torch.randn((agent_obs.shape[0], 1, self.F.shape[0]), generator=gen,
                            device=agent_obs.device)
        action, _, _ = sac.sample(st["sac"]["policy"], agent_obs, noise, (1, self.F.shape[0]))
        return action

    # --------------------------------------------------------------- phases
    def collect(self, st, gen):
        env = self.cfg["env"]
        u = st["u"]
        raw = u[:, None, :]
        action = self.act(st, gen, scale(raw, st["vmin"], st["vmax"]))
        env_action = unscale(action, -1.0, 1.0)
        u1, r = self.period(u, self.field(env_action)[:, 0])
        step = st["step"] + 1
        trunc = step >= env["max_episode_steps"]
        idx = torch.randint(0, st["pool"].shape[0], trunc.shape, generator=gen, device=u.device)
        st["u"] = torch.where(trunc[:, None], st["pool"][idx], u1)
        st["step"] = torch.where(trunc, torch.zeros_like(step), step)
        for seen in (st["u"], u1):
            st["vmin"] = torch.minimum(seen.min(), st["vmin"])
            st["vmax"] = torch.maximum(seen.max(), st["vmax"])
        R.write(st["replay"], raw, env_action, r, torch.zeros_like(trunc), trunc,
                u1[:, None, :], step)

    def imagine(self, st, gen):
        cfg, env = self.cfg, self.cfg["env"]
        h = cfg["horizon"]
        for _ in range(cfg["rounds"]):
            ws = self.world_start(st, gen)
            for k in range(h):
                prev_obs, prev_t = ws["obs"], ws["t"]
                action = self.act(st, gen, prev_obs)
                waction = self.world_action(unscale(action, -1.0, 1.0))
                outs, hidden = self.rollout_all(st, ws["obs"][:, None], waction[:, None],
                                                ws["hidden"])
                sel = self.select(st, gen, outs[:, :, 0])
                phys = unscale(sel, st["vmin"], st["vmax"])[:, 0]
                phi = unscale(waction, self.pmin, self.pmax)[:, 0]
                reward = ks.reward(phys, phi, env["length"] / env["n"], self.objective)
                stepped = {"obs": sel, "hidden": hidden, "t": ws["t"] + 1, "sim": ws["sim"] + 1}
                done = (stepped["t"] >= env["max_episode_steps"]) | (stepped["sim"] >= h)
                all_done = torch.all(done)
                trunc = torch.broadcast_to(all_done, done.shape)
                ws = stepped
                if k < h - 1:
                    fresh = self.world_start(st, gen)
                    ws = {"obs": torch.where(all_done, fresh["obs"], sel),
                          "hidden": tuple(torch.where(all_done, a, b)
                                          for a, b in zip(fresh["hidden"], hidden)),
                          "t": torch.where(all_done, fresh["t"], stepped["t"]),
                          "sim": torch.where(all_done, fresh["sim"], stepped["sim"])}
                R.write(st["world_replay"], prev_obs, action, reward, torch.zeros_like(trunc),
                        trunc, sel, prev_t + 1)

    def policy(self, st, gen):
        cfg = self.cfg
        bs = cfg["policy_batch"]
        w_n = st["world_replay"]["fill"].sum().to(torch.float32)
        p_imag = w_n / torch.clamp(w_n + st["replay"]["fill"].sum(), min=1)
        for _ in range(cfg["updates"]):
            real = R.transitions(st["replay"], gen, bs)
            real["obs"] = scale(real["obs"], st["vmin"], st["vmax"])
            real["nxtobs"] = scale(real["nxtobs"], st["vmin"], st["vmax"])
            imag = R.transitions(st["world_replay"], gen, bs)
            for part in (real, imag):
                part["actions"] = scale(part["actions"], -1.0, 1.0)
            pick = torch.rand((bs,), generator=gen, device=w_n.device) < p_imag
            batch = {k: torch.where(pick.reshape((-1,) + (1,) * (imag[k].ndim - 1)),
                                    imag[k], real[k]) for k in imag}
            batch = {k: (v.float() if k in ("obs", "actions", "nxtobs", "rewards") else v)
                     for k, v in batch.items()}
            sac.update(st["sac"], batch, gen, cfg)

    def iterate(self, state: Dict, gen) -> Dict:
        st = copy.deepcopy(state)
        with torch.no_grad():
            self.collect(st, gen)
            self.imagine(st, gen)
        self.policy(st, gen)
        return st
