"""Surrogate evaluation metric battery (port of
``pdecontrol_tpu/train/metrics.py``; reference ``test_step``,
``surrogates/training.py:176-271``): an open-loop free-run from a tau
warmup, then

  * state metrics: MSE, L1/L2 norms per horizon step, relative L1/L2, NRMSE
    (norms over the spatial axis, averaged over batch and channels);
  * reward metrics: the env reward recomputed from true vs predicted states
    with the forcing field from the logged actions, scored per step with
    L1/L2/relative/NRMSE over the batch axis;
  * derivative metrics: the env's spatial derivatives (KS: u_x
    upwind-of-u^2, u_xx, u_xxxx; Burgers: u_x, u_xx) recomputed on true vs
    predicted states.

All metrics are computed in *unscaled* (physical) space
(training.py:191-193).  The per-sample Python loops of the reference
(training.py:214-233) are batched evaluations here.
"""

from __future__ import annotations

from typing import Dict

import torch

from pdecontrol_tpu_torch.data.types import Sample
from pdecontrol_tpu_torch.envs.transforms import Normalize, SampleTransform
from pdecontrol_tpu_torch.models.surrogate import PDESurrogate

EPS = 1e-12


def _state_metrics(prefix: str, outputs: torch.Tensor, states: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    diff = outputs - states
    l1 = torch.sum(torch.abs(diff), dim=3)
    l2 = torch.sqrt(torch.sum(diff**2, dim=3))
    s1 = torch.sum(torch.abs(states), dim=3)
    s2 = torch.sqrt(torch.sum(states**2, dim=3))
    return {
        f"{prefix}l1_loss": torch.mean(l1, dim=(0, 2)),
        f"{prefix}l2_loss": torch.mean(l2, dim=(0, 2)),
        f"{prefix}l1_loss_scaled": torch.mean(l1 / (s1 + EPS), dim=(0, 2)),
        f"{prefix}l2_loss_scaled": torch.mean(l2 / (s2 + EPS), dim=(0, 2)),
        f"{prefix}nrmse": torch.mean(l2**2 / (s2**2 + EPS), dim=(0, 2)),
    }


@torch.no_grad()
def surrogate_metric_battery(
    module: PDESurrogate,
    batch: Sample,
    stransf: SampleTransform,
    und: Normalize,
    env,
    tau: int,
) -> Dict[str, torch.Tensor]:
    """Full test battery on a transformed batch ([B, T, C, H] obs/actions)."""
    states, actions = batch.obs, batch.actions

    roll = module.rollout(states[:, :tau], actions, dscaling=und.inv)
    # IC-augmented prediction sequence (training.py:186-189).
    outputs = torch.cat([states[:, :1], roll.outputs[:, :-1]], dim=1)

    states_u = stransf.otransf.inverse(states)
    outputs_u = stransf.otransf.inverse(outputs)

    metrics: Dict[str, torch.Tensor] = {"MSE": torch.mean((outputs_u - states_u) ** 2)}
    metrics.update(_state_metrics("", outputs_u, states_u))

    # ---- reward metrics (training.py:204-225)
    env_actions = stransf.atransf.inverse(actions)
    phi = env.forcing.apply(env_actions)  # [B, T, C, H]
    b, t = states.shape[:2]

    def flat(x):
        return x.reshape((b * t,) + tuple(x.shape[2:]))

    rews = env.reward_fn(flat(states_u), flat(phi)).reshape(b, t)
    pred = env.reward_fn(flat(outputs_u), flat(phi)).reshape(b, t)
    dr = rews - pred
    r1 = torch.sum(torch.abs(dr), dim=0)
    r2 = torch.sqrt(torch.sum(dr**2, dim=0))
    n1 = torch.sum(torch.abs(rews), dim=0)
    n2 = torch.sqrt(torch.sum(rews**2, dim=0))
    metrics.update({
        "l1_loss_rews": r1,
        "l2_loss_rews": r2,
        "l1_loss_scaled_rews": r1 / (n1 + EPS),
        "l2_loss_scaled_rews": r2 / (n2 + EPS),
        "nrmse_rews": r2**2 / (n2**2 + EPS),
    })

    # ---- derivative metrics (training.py:227-248)
    if hasattr(env.ops, "central"):
        from pdecontrol_tpu_torch.ops.kuramoto import ks_derivatives as derivatives
    else:
        from pdecontrol_tpu_torch.ops.burgers import burgers_derivatives as derivatives

    def derivs_fn(u):  # [B, T, C, H] -> [B, T, D, C, H]
        return torch.stack(derivatives(env.ops, u.to(env.dtype)), dim=2)

    dt_true = derivs_fn(states_u)
    dt_pred = derivs_fn(outputs_u)
    dd = dt_pred - dt_true
    d1 = torch.sum(torch.abs(dd), dim=4)
    d2 = torch.sqrt(torch.sum(dd**2, dim=4))
    t1 = torch.sum(torch.abs(dt_true), dim=4)
    t2 = torch.sqrt(torch.sum(dt_true**2, dim=4))
    names = ("l1_loss_derivs", "l2_loss_derivs", "l1_loss_scaled_derivs",
             "l2_loss_scaled_derivs", "nrms_derivs")
    values = (
        torch.mean(d1, dim=(0, 3)),
        torch.mean(d2, dim=(0, 3)),
        torch.mean(d1 / (t1 + EPS), dim=(0, 3)),
        torch.mean(d2 / (t2 + EPS), dim=(0, 3)),
        torch.mean(d2**2 / (t2**2 + EPS), dim=(0, 3)),
    )
    for name, val in zip(names, values):  # val: [T, D]
        for d in range(val.shape[1]):
            metrics[f"{name}-derivative-{d}"] = val[:, d]

    metrics["states"] = states_u
    metrics["outputs"] = outputs_u
    metrics["actions"] = env_actions
    return metrics
