"""Offline dataset generation CLI (port of
``pdecontrol_tpu/evaluation/generate.py``; reference
``pdecontrol/surrogates/evaluation/generate.py``): roll ``--episodes``
random-action episodes of the chosen env and save the batched trajectory
tensors.  All episodes advance together as one batch.

Output: an ``.npz`` with obs/actions/nxtobs/rewards/terminated/truncated/
steps arrays of shape ``[episodes, T, ...]`` (the reference's TensorDataset
layout, generate.py:40-63).  It runs on the GPU, and stops if there is
none, unless ``--platform cpu`` asks for the CPU; ``--config`` is the env's
configuration (``{"solver": "pallas"}`` sends the KS periods through the
CUDA kernel).

    python -m pdecontrol_tpu_torch.evaluation.generate \\
        --env KuramotoSivashinskyEnv-v0 --episodes 100 --output ks_attractor.npz
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from pdecontrol_tpu_torch.mbrl.agents import RandomAgent
from pdecontrol_tpu_torch.utils.device import (
    add_platform_argument, entry_device, platform_device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", type=str, default="KuramotoSivashinskyEnv-v0")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--config", type=str, default="{}")
    p.add_argument("--seed", type=int, default=0)
    add_platform_argument(p)
    return p


@torch.no_grad()
def generate(env_id: str, episodes: int, config: dict, seed: int = 0,
             device: Optional[torch.device] = None) -> Dict[str, np.ndarray]:
    from pdecontrol_tpu_torch.mbrl.controller import ENVS

    dev = entry_device(device)
    env_cls, make_pool = ENVS[env_id]
    env = env_cls.create(**config, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = make_pool(env, gen, max(episodes, 8))
    state = env.reset_from_pool(gen, pool, (episodes,))
    agent = RandomAgent(env.action_shape, env.action_low, env.action_high)

    traj = []
    for _ in range(env.max_episode_steps):
        obs = env.observe(state)
        action = agent.select_action(None, obs, gen)
        state, out = env.step(state, action)
        traj.append((obs, action, out.obs, out.reward, out.terminated, out.truncated,
                     out.info["step"]))

    # time-major -> episode-major
    obs, actions, nxt, rewards, term, trunc, steps = (
        torch.stack(xs, dim=1).cpu().numpy() for xs in zip(*traj))
    return {
        "obs": obs.astype(np.float32),
        "actions": actions.astype(np.float32),
        "nxtobs": nxt.astype(np.float32),
        "rewards": rewards.astype(np.float32),
        "terminated": term,
        "truncated": trunc,
        "steps": steps.astype(np.int32),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    data = generate(args.env, args.episodes, json.loads(args.config), args.seed,
                    device=platform_device(args.platform))
    np.savez_compressed(args.output, **data)
    print(f"wrote {args.output}: obs {data['obs'].shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
