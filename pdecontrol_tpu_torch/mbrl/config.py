"""Typed MBPO configuration with the reference's CLI defaults
(pdecontrol ``mbrl/script.py:16-74``) and its JSON-dict override ergonomics
(factory defaults deep-merged under CLI JSON, script.py:100-108).

A copy of ``pdecontrol_tpu.mbrl.config`` (plain Python), kept in the port so
that importing it never runs the JAX package's ``__init__``.  The fields are
the JAX package's, so the two CLIs share one flag surface; fields that name
features the port does not have yet are rejected by the port's controller.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class MBPOConfig:
    # ---- logging & evaluation (script.py:18-24)
    project: Optional[str] = None
    name: Optional[str] = None
    run_dir: str = "runs/mbpo"
    use_wandb: bool = False
    agent_eval_freq: int = 50
    num_eval_episodes: int = 10
    surrogate_eval_horizon: int = 30  # open-loop eval steps (mbrl.py:474)
    status_report_freq: int = 5
    logging_freq: int = 10
    checkpoint_freq: int = 0  # iterations between snapshots (0 = off)
    resume: bool = False
    profile_dir: Optional[str] = None  # device trace of iteration 1
    # The JAX package fuses a non-retrain iteration (collect -> imagine ->
    # SAC) into one program and a whole surrogate fit into one on-device
    # loop.  The port runs the fused iteration as one CUDA graph per horizon,
    # captured at that horizon's first non-retrain iteration (so it has no
    # precompile ladder: precompile_horizons changes nothing), the phases of
    # the other iterations as one graph each, and, with fuse_fit, the fit's
    # TBPTT and validation steps as CUDA graphs replayed every epoch
    # (fuse_fit=False: the same fit, eagerly).
    fuse_iteration: bool = True
    fuse_fit: bool = True
    precompile_horizons: bool = True

    # ---- general (script.py:27-29)
    total_timesteps: int = 1_000_000
    seed: int = 0

    # ---- device mesh: data_parallel shards env / training batches,
    # model_parallel shards ensemble members.  1x1 is the single-device path.
    data_parallel: int = 1
    model_parallel: int = 1

    # ---- simulation env & rollouts (script.py:32-36)
    env_id: str = "KuramotoSivashinskyEnv-v0"
    env_config: Dict = dataclasses.field(default_factory=dict)
    num_envs: int = 10  # reference --cpus (one subprocess each; here a batch axis)
    gamma: float = 0.99
    capacity: int = 1_000_000
    rollout_length: int = 1
    pool_size: int = 256  # amortised-reset pool
    # Sensor strides (reference setup_transforms, mbrl.py:170-175).
    # agent_stride subsamples the SAC agent's observations; world_stride > 1
    # is rejected: the world reward recomputation needs the inverse sensor,
    # which is undefined for strided sensors in the reference too.
    agent_stride: int = 1
    world_stride: int = 1

    # ---- MBPO (script.py:39-46)
    learning_starts: int = 20_000
    policy_train_steps_per_sample: int = 5
    model_buffer_store_iterations: int = 30
    model_rollouts_per_sample: int = 100
    model_rollouts_batch_size: int = 100
    model_buffer_max_capacity: int = 1_000_000
    val_split_ratio: float = 0.1
    rollout_length_schedule: Dict = dataclasses.field(default_factory=dict)

    # ---- surrogate training (script.py:49-57)
    surrogate_train_freq: int = 500
    loss: str = "MSELoss"
    factory: str = "KSAutoRegConvolutionalLSTM"
    model: Dict = dataclasses.field(default_factory=dict)
    surrogate: Dict = dataclasses.field(default_factory=dict)
    training: Dict = dataclasses.field(default_factory=dict)
    curriculum: Dict = dataclasses.field(default_factory=dict)
    trainer: Dict = dataclasses.field(default_factory=dict)

    # ---- ensemble (script.py:60-61)
    num_dynamics_models: int = 3
    num_elite_models: int = 3
    vmap_ensemble_training: bool = True  # all members in lock-step; False
    # fits them one after another

    # ---- SAC (script.py:64-72)
    policy: str = "Gaussian"
    policy_batch_size: int = 256
    sac_tau: float = 0.005
    target_entropy: float = -3.0
    lr: float = 3e-4
    alpha: float = 0.2
    target_update_interval: int = 1
    hidden_size: int = 256
    automatic_entropy_tuning: bool = False
    reward_scale: float = 1.0  # SAC-update reward scaling

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def merged_with_factory_defaults(self, defaults: Dict) -> "MBPOConfig":
        """Factory defaults under CLI JSON overrides (script.py:100-108)."""
        out = dataclasses.replace(self)
        for field in ("model", "surrogate", "training", "curriculum", "trainer"):
            out_field = {**defaults.get(field, {}), **getattr(self, field)}
            setattr(out, field, out_field)
        return out
