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

``--chunk`` env steps, each with its SAC updates, are one program, as the
JAX trainer's jitted chunk is: on the card a CUDA graph (``utils/graphs.py``)
keyed as the JAX trainer's ``_chunk_jit`` (steps, random, updates per step),
captured after the first chunk, which runs eagerly, and replayed for every
later one; a log record follows each chunk.  The evaluation's episodes are a
graph too, keyed by their length.  The random warmup runs once, eagerly.
Under ``--debug_nans`` and on the CPU every chunk runs eagerly.  It runs on
the GPU, and stops if there is none, unless ``--platform cpu`` asks for the
CPU.
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
from pdecontrol_tpu_torch.utils.graphs import GraphCache, copy_into, tensors_of
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
                   help="env steps fused per chunk (one CUDA graph on the GPU), and "
                        "between log records")
    return p


class SACTrainer:
    def __init__(self, args: argparse.Namespace, device: Optional[torch.device] = None,
                 graphs: bool = True):
        """``graphs=False`` runs every chunk and evaluation eagerly on the
        card too (the graphs' reference)."""
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
        self.graphs = (GraphCache([self.gen])
                       if dev.type == "cuda" and graphs and self.finite is None else None)

    def _graph(self, key, what: str, body, state):
        """``body`` eagerly, or on the card through its CUDA graph under
        ``key`` (``GraphCache.run``)."""
        if self.graphs is None:
            return body()
        captured = []
        out = self.graphs.run(key, body, state, what,
                              counters=((self.sac_state, "updates"),), captured=captured)
        for g in captured:
            print(f"[graphs] captured {what} {key} in {g.seconds:.2f} s; the shared pool "
                  f"grew by {g.pool_bytes / 1e6:.1f} MB", flush=True)
        return out

    def _batch(self) -> Sample:
        batch = self.tr.replay_to_agent(
            R.sample_transitions(self.replay, self.gen, self.args.batch_size))
        return batch.replace(obs=batch.obs.float(), actions=batch.actions.float(),
                             nxtobs=batch.nxtobs.float(), rewards=batch.rewards.float())

    def run_chunk(self, nsteps: int, random: bool, updates_per_step: int):
        """``nsteps`` env steps of all envs, each followed (unless ``random``)
        by ``updates_per_step`` SAC updates; returns (per-step rewards
        [nsteps, num_envs], the last update's qf loss or 0).  The env state,
        the obs scaling, the replay and the agent change in place.  A chunk
        of the policy replays its CUDA graph on the card; the random warmup
        runs eagerly."""
        def body():
            return self._chunk_body(nsteps, random, updates_per_step)

        if random:
            packed = body()
        else:
            packed = self._graph(
                ("chunk", nsteps, random, updates_per_step), "the SAC baseline's chunk", body,
                lambda: tensors_of(self.env_state, self.tr, self.pool, self.replay,
                                   self.sac_state))
        return packed[:-1].reshape(nsteps, -1), packed[-1]

    def _chunk_body(self, nsteps: int, random: bool, updates_per_step: int) -> torch.Tensor:
        """The chunk's per-step rewards and last qf loss as one vector."""
        env, sac = self.env, self.sac
        state, tr = self.env_state, self.tr
        rewards = []
        qf = torch.zeros((), device=self.device)
        for _ in range(nsteps):
            with torch.no_grad():
                raw_obs = env.observe(state)
                if random:
                    action = self.random_agent.select_action(None, raw_obs, self.gen)
                else:
                    action = sac.select_action(
                        self.sac_state, tr.raw_to_agent_obs(raw_obs), self.gen)
                env_action = tr.agent_to_env_action(action)
                state, out = env.vec_step(state, env_action, self.pool)
                if self.finite is not None:
                    self.finite("collect (env step)", field=out.info["final_obs"],
                                reward=out.reward)
                tr = tr.replace(oscaling=tr.oscaling.update(out.obs)
                                .update(out.info["final_obs"]))
                R.write_step(self.replay, raw_obs, env_action, out.reward,
                             out.terminated, out.truncated, out.info["final_obs"],
                             out.info["step"])
            rewards.append(out.reward)
            if updates_per_step and not random:
                # The updates' batches read the scaling of this step.
                copy_into(self.tr.oscaling, tr.oscaling)
                tr = self.tr
                self.sac_state, m = sac.update_many(
                    self.sac_state, (self._batch() for _ in range(updates_per_step)),
                    self.gen)
                qf = m["qf_loss"]
        copy_into(self.env_state, state)
        copy_into(self.tr.oscaling, tr.oscaling)
        rewards = torch.stack(rewards)
        return torch.cat([rewards.reshape(-1), qf.reshape(1).to(rewards.dtype)])

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Deterministic episodes from the pool (no auto-reset); on the card
        a CUDA graph keyed by the episodes' length."""
        steps = self.env.max_episode_steps
        stats = self._graph(("evaluate", steps), "the SAC baseline's evaluation",
                            lambda: self._evaluate_body(steps),
                            lambda: tensors_of(self.tr, self.pool, self.sac_state.policy))
        mean, std = stats.tolist()
        return {"eval_return_mean": mean, "eval_return_std": std}

    @torch.no_grad()
    def _evaluate_body(self, steps: int) -> torch.Tensor:
        """The returns' mean and std over ``num_eval_episodes`` episodes."""
        env, sac = self.env, self.sac
        state = env.reset_from_pool(self.gen, self.pool, (self.args.num_eval_episodes,))
        rewards = []
        for _ in range(steps):
            obs = self.tr.raw_to_agent_obs(env.observe(state))
            action = sac.select_action(self.sac_state, obs, self.gen, deterministic=True)
            state, out = env.step(state, self.tr.agent_to_env_action(action))
            rewards.append(out.reward)
        returns = torch.stack(rewards).sum(0)
        return torch.stack([returns.mean(), returns.std(correction=0)])

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
