"""Model-free SAC baseline on the real PDE env (port of
``pdecontrol_tpu/sac/train.py``).

The ECC'24 paper's comparison arm: SAC trained on real transitions only (of
the KS env, or of the Burgers env with ``--env_id BurgersEnv-v0``),
collect-then-update over the batched env, with env, agent and replay on
one device.  A random warmup of ``--learning_starts`` steps, then per env
step of all ``--num_envs`` envs ``--updates_per_step`` SAC updates on
uniform replay batches; a policy evaluation every ``--eval_freq`` env steps.

    python -m pdecontrol_tpu_torch.sac.train --total_timesteps 50000 \\
        --learning_starts 5000 --num_envs 10 --updates_per_step 1 \\
        --env_config '{"solver": "pallas_packed", "pallas_precision": "bf16_3x"}'

The JAX trainer fuses ``--chunk`` env steps into one jitted program; the
port runs them as an eager loop, and ``--chunk`` is the number of env steps
between two log records.  It runs on the GPU, and stops if there is none,
unless ``--platform cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import torch

from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.data.types import Sample
from pdecontrol_tpu_torch.mbrl.agents import RandomAgent
from pdecontrol_tpu_torch.mbrl.transform_sets import ControllerTransforms
from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig
from pdecontrol_tpu_torch.utils.device import (
    add_platform_argument, entry_device, platform_device)
from pdecontrol_tpu_torch.utils.logging import MetricsLogger
from pdecontrol_tpu_torch.utils.profiling import FiniteChecks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_platform_argument(p)
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first non-finite env step or "
                        "SAC loss; anomaly detection in the backward passes")
    p.add_argument("--run_dir", type=str, default="runs/sac")
    p.add_argument("--env_id", type=str, default="KuramotoSivashinskyEnv-v0")
    p.add_argument("--env_config", type=str, default="{}")
    p.add_argument("--num_envs", type=int, default=10)
    p.add_argument("--total_timesteps", type=int, default=1_000_000)
    p.add_argument("--learning_starts", type=int, default=20_000)
    p.add_argument("--updates_per_step", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--capacity", type=int, default=1_000_000)
    p.add_argument("--pool_size", type=int, default=256)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--tau", type=float, default=0.005)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--automatic_entropy_tuning", action="store_true")
    p.add_argument("--reward_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_freq", type=int, default=2000,
                   help="eval every N env steps")
    p.add_argument("--num_eval_episodes", type=int, default=10)
    p.add_argument("--chunk", type=int, default=100,
                   help="env steps between log records (the JAX trainer's jitted "
                        "chunk; an eager loop here)")
    return p


class SACTrainer:
    def __init__(self, args: argparse.Namespace, device: Optional[torch.device] = None):
        from pdecontrol_tpu_torch.mbrl.controller import ENVS

        self.args = args
        # --debug_nans: finiteness checks on every env step and SAC update.
        self.finite = FiniteChecks() if args.debug_nans else None
        self.device = dev = entry_device(device)
        torch.manual_seed(args.seed)  # network initialisation
        self.gen = torch.Generator(device=dev).manual_seed(args.seed)
        env_cls, make_pool = ENVS[args.env_id]
        self.env = env_cls.create(**json.loads(args.env_config), device=dev)

        self.tr = ControllerTransforms.create(self.env, dtype=self.env.dtype, device=dev)
        self.pool = make_pool(self.env, self.gen, args.pool_size)

        sac_cfg = SACConfig(
            gamma=args.gamma, tau=args.tau, alpha=args.alpha, lr=args.lr,
            hidden=args.hidden_size,
            automatic_entropy_tuning=args.automatic_entropy_tuning,
            reward_scale=args.reward_scale,
        )
        self.sac = SAC(self.env.obs_shape, self.env.action_shape, sac_cfg,
                       self.env.action_low, self.env.action_high, device=dev,
                       check=self.finite)
        self.sac_state = self.sac.init()
        self.random_agent = RandomAgent(self.env.action_shape, self.env.action_low,
                                        self.env.action_high)

        rows = max(args.capacity // self.env.max_episode_steps, args.num_envs + 2)
        self.replay = R.create(rows, self.env.max_episode_steps, args.num_envs,
                               self.env.obs_shape, self.env.action_shape,
                               self.env.dtype, device=dev)
        self.env_state = self.env.reset_from_pool(self.gen, self.pool, (args.num_envs,))
        self.tr = self.tr.replace(
            oscaling=self.tr.oscaling.update(self.env.observe(self.env_state))
        )

    def _batch(self) -> Sample:
        batch = self.tr.replay_to_agent(
            R.sample_transitions(self.replay, self.gen, self.args.batch_size))
        return batch.replace(obs=batch.obs.float(), actions=batch.actions.float(),
                             nxtobs=batch.nxtobs.float(), rewards=batch.rewards.float())

    def run_chunk(self, nsteps: int, random: bool, updates_per_step: int):
        """``nsteps`` env steps of all envs, each followed (unless ``random``)
        by ``updates_per_step`` SAC updates; returns (per-step rewards
        [nsteps, num_envs], the last update's qf loss or 0)."""
        env, sac = self.env, self.sac
        rewards = []
        qf = torch.zeros((), device=self.device)
        for _ in range(nsteps):
            with torch.no_grad():
                raw_obs = env.observe(self.env_state)
                if random:
                    action = self.random_agent.select_action(None, raw_obs, self.gen)
                else:
                    action = sac.select_action(
                        self.sac_state, self.tr.raw_to_agent_obs(raw_obs), self.gen)
                env_action = self.tr.agent_to_env_action(action)
                self.env_state, out = env.vec_step(self.env_state, env_action, self.pool)
                if self.finite is not None:
                    self.finite("collect (env step)", field=out.info["final_obs"],
                                reward=out.reward)
                self.tr = self.tr.replace(oscaling=self.tr.oscaling.update(out.obs)
                                          .update(out.info["final_obs"]))
                R.write_step(self.replay, raw_obs, env_action, out.reward,
                             out.terminated, out.truncated, out.info["final_obs"],
                             out.info["step"])
            rewards.append(out.reward)
            if updates_per_step and not random:
                self.sac_state, m = sac.update_many(
                    self.sac_state, (self._batch() for _ in range(updates_per_step)),
                    self.gen)
                qf = m["qf_loss"]
        return torch.stack(rewards), qf

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Deterministic episodes from the pool (no auto-reset)."""
        env, sac = self.env, self.sac
        state = env.reset_from_pool(self.gen, self.pool, (self.args.num_eval_episodes,))
        rewards = []
        for _ in range(env.max_episode_steps):
            obs = self.tr.raw_to_agent_obs(env.observe(state))
            action = sac.select_action(self.sac_state, obs, self.gen, deterministic=True)
            state, out = env.step(state, self.tr.agent_to_env_action(action))
            rewards.append(out.reward)
        returns = torch.stack(rewards).sum(0)
        mean, std = torch.stack([returns.mean(), returns.std(correction=0)]).tolist()
        return {"eval_return_mean": mean, "eval_return_std": std}

    def learn(self, logger: MetricsLogger) -> None:
        args = self.args
        start = time.time()
        warmup = max(args.learning_starts // args.num_envs, 1)
        self.run_chunk(warmup, True, 0)
        steps_done = warmup * args.num_envs

        next_eval = steps_done
        while steps_done < args.total_timesteps:
            if self.finite is not None:
                self.finite.iteration = steps_done  # env steps, this loop's count
            rew, qf = self.run_chunk(args.chunk, False, args.updates_per_step)
            steps_done += args.chunk * args.num_envs
            rmean, qf = torch.stack([rew.mean().double(), qf.double()]).tolist()
            record = {
                "num_steps_sampled": steps_done,
                "collect_reward_mean": rmean,
                "sac_qf_loss": qf,
                "time": time.time() - start,
            }
            if steps_done >= next_eval:
                record.update(self.evaluate())
                next_eval += args.eval_freq
            logger.log(record, commit=True)
            print(f"[sac] steps={steps_done} "
                  f"eval={record.get('eval_return_mean', float('nan')):.2f} "
                  f"rew={record['collect_reward_mean']:.3f}", flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trainer = SACTrainer(args, device=platform_device(args.platform))
    logger = MetricsLogger(args.run_dir, config=vars(args))
    anomaly = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(anomaly or args.debug_nans)
    try:
        trainer.learn(logger)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        logger.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
