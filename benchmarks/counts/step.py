"""FLOPs of a whole unit of a cell's work, from the sizes of the controller's
configuration: one MBPO iteration, and one lock-step TBPTT step and one
validation pass of a retrain."""

from typing import Dict

from benchmarks.counts import k1, sac, surrogate
from benchmarks.reference.surrogate import FAMILIES


def iteration(ctl, horizon: int) -> float:
    """One iteration: K1's physics, the policy's action passes, the
    ensemble's world starts and steps, the SAC updates."""
    cfg, env = ctl.config, ctl.env
    pf = sac.policy_forward(env.n, env.num_jets, cfg.hidden_size)
    m, b = cfg.num_dynamics_models, cfg.model_rollouts_batch_size
    # A start per round and a fresh one at every step but a round's last.
    world = ctl.world_rounds * m * b * (horizon * surrogate.teacher_forced(env.n, ctl.tau)
                                        + horizon * surrogate.teacher_forced(env.n, 1))
    actions = (cfg.num_envs * cfg.rollout_length + ctl.world_rounds * horizon * b) * pf
    collect = cfg.rollout_length * k1.flops(cfg.num_envs, env.n, env.cfg_steps)
    updates = ctl.num_pol_updates_per_iteration * sac.update(
        env.n, env.num_jets, cfg.hidden_size, cfg.policy_batch_size)
    return collect + actions + world + updates


def fit(ctl) -> Dict[str, float]:
    """A later retrain's lock-step step of every member, and its validation
    pass, at the retrain's starting window length."""
    cfg, n = ctl.config, ctl.env.n
    tc = ctl.train_cfgs["iterations"]
    length = tc.tau + int(ctl.curriculum(iteration=ctl.iteration, epoch=0, step=0))
    m, b = cfg.num_dynamics_models, tc.batch_size
    return {"step": m * b * surrogate.train_window(n, FAMILIES[cfg.factory], length, tc.tau,
                                                   tc.tbtt),
            "val": m * b * surrogate.val_window(n, length, tc.tau)}
