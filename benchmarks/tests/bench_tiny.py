"""The benchmark's cells at a size a CPU test can run: the flagship's and the
latent family's structure (every phase, every draw, every graph key of the
window) on 32-point KS episodes of 8 steps, 2 envs, 3 members of which 2
are elites, small networks, and horizons and budgets cut to match."""

from __future__ import annotations

import json

import torch

from benchmarks.harness.cell import Cell

TINY = ["--env_config", json.dumps({"n": 32, "cfg_steps": 5, "t_max": 0.04, "transient_time": 0.5}),
        "--num_envs", "2", "--learning_starts", "8", "--capacity", "512", "--pool_size", "8",
        "--policy_train_steps_per_sample", "1", "--model_rollouts_per_sample", "2",
        "--model_rollouts_batch_size", "4", "--model_buffer_store_iterations", "2",
        "--model_buffer_max_capacity", "64", "--num_elite_models", "2",
        "--policy_batch_size", "8", "--hidden_size", "32", "--total_timesteps", "40"]
TINY_FIT = ['--trainer', json.dumps({"initial": {"min_steps": 2, "max_steps": 6},
                                     "iterations": {"min_steps": 2, "max_steps": 6}}),
            "--training", json.dumps({"tau": 2, "initial": {"tbtt": 3, "patience": 2, "batch_size": 4},
                                      "iterations": {"tbtt": 3, "patience": 2, "batch_size": 4}}),
            "--curriculum", json.dumps({"scheduler": "LinearScheduler", "steptype": "iteration",
                                        "start": 0, "stop": 10, "vmin": 4, "vmax": 4})]


def tiny_cell(workload: str, seed: int = 3, trace: bool = False) -> Cell:
    """``workload``'s cell with the tiny sizes laid over its configuration's
    arguments, on the CPU."""
    cell = Cell.load(workload, seed, seconds=0.0, trace=trace)
    cell.config = dict(cell.config, args=list(cell.config["args"]) + TINY + TINY_FIT)
    if cell.traffic["driver"] == "fused_iteration":
        cell.traffic = dict(cell.traffic, horizon=3, args=[
            "--rollout_length_schedule",
            json.dumps({"scheduler": "ConstantLengthScheduler", "length": 3})])
    else:
        cell.traffic = dict(cell.traffic, replay_transitions=60, iteration=5, settle_s=0)
    cell.device = torch.device("cpu")
    return cell
