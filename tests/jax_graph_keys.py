"""The JAX side of ``tests/test_torch_graph_keys.py``: the keys of the JAX
package's jit caches after a tiny ``learn()`` of the MBPO controller, a
tiny ``learn()`` of the SAC baseline and a tiny one-member ``fit``, printed
as one JSON object.  The test runs it in a process of its own, so that it
can turn the XLA CPU compiler's optimisations off (compiling dominates
these runs, and the keys do not depend on the machine code):

    XLA_FLAGS=--xla_backend_optimization_level=0 python tests/jax_graph_keys.py DIR

The runs' arguments are shared with the test, which makes the same runs
with the port.
"""

from __future__ import annotations

import json
import os
import sys

# The tiny MBPO run: 8 random warmup steps of each of 2 envs (one whole
# 8-step episode each), then iteration 0 (a retrain and an evaluation of
# the policy and, on a finished episode, of the surrogate) and iteration 1,
# every phase on its own (--no_fuse_iteration).  The plain solver and the
# fully connected family keep the JAX side's compiles short.
MBPO_ARGS = [
    "--env_config", json.dumps({"n": 16, "cfg_steps": 5, "t_max": 0.04}),
    "--num_envs", "2", "--total_timesteps", "20", "--learning_starts", "16",
    "--pool_size", "8", "--surrogate_train_freq", "8", "--solver", "xla",
    "--factory", "KSAutoRegFullyConnectedLSTM",
    "--policy_train_steps_per_sample", "1", "--model_rollouts_per_sample", "2",
    "--model_rollouts_batch_size", "4", "--num_dynamics_models", "2",
    "--policy_batch_size", "8", "--agent_eval_freq", "4", "--num_eval_episodes", "2",
    "--surrogate_eval_horizon", "4", "--logging_freq", "0", "--hidden_size", "16",
    "--rollout_length_schedule", json.dumps({"scheduler": "ConstantLengthScheduler",
                                             "length": 2}),
    "--training", json.dumps({"tau": 2, "initial": {"tbtt": 4, "patience": 2,
                                                    "batch_size": 4},
                              "iterations": {"tbtt": 4, "patience": 1, "batch_size": 4}}),
    "--trainer", json.dumps({"initial": {"min_steps": 2, "max_steps": 6},
                             "iterations": {"min_steps": 1, "max_steps": 3}}),
    "--curriculum", json.dumps({"scheduler": "ConstantLengthScheduler", "length": 3}),
    "--no_fuse_iteration",
]
# The SAC baseline: a random warmup of 8 steps of 2 envs, then 3 chunks of
# 4 steps with one update each, and evaluations at 16 and 24 env steps.
SAC_ARGS = [
    "--env_config", json.dumps({"n": 16, "cfg_steps": 5, "t_max": 0.04}),
    "--num_envs", "2", "--total_timesteps", "40", "--learning_starts", "16",
    "--batch_size", "8", "--pool_size", "8", "--chunk", "4", "--eval_freq", "8",
    "--num_eval_episodes", "2", "--hidden_size", "16",
]
# The one-member fit: rows of 16 steps, 4 of them train rows, windows of
# tau 2 + K, K growing from 3 to 5 over the epochs (two window lengths).
FIT = {"N": 16, "fill": [16] * 6 + [0, 0], "train": [1, 1, 1, 1, 0, 0, 0, 0],
       "config": dict(tau=2, tbtt=4, lr=2e-3, lr_gamma=0.5, step_size=1, batch_size=4,
                      patience=50, max_epochs=3),
       "curriculum": {"scheduler": "LinearScheduler", "steptype": "epoch", "start": 0,
                      "stop": 2, "vmin": 3, "vmax": 5}}


def _listed(keys):
    return sorted(json.loads(json.dumps(list(keys))))


def main(run_dir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from pdecontrol_tpu.data import replay as R
    from pdecontrol_tpu.envs.transforms import Identity, SampleTransform
    from pdecontrol_tpu.mbrl import script
    from pdecontrol_tpu.mbrl.controller import PDEModelBasedController
    from pdecontrol_tpu.models import factories
    from pdecontrol_tpu.sac import train as sac_train
    from pdecontrol_tpu.train.losses import mse_loss
    from pdecontrol_tpu.train.schedulers import Scheduler
    from pdecontrol_tpu.train.trainer import SurrogateTrainer, TrainConfig
    from pdecontrol_tpu.utils.logging import MetricsLogger

    out = {}
    cfg = script.config_from_args(script.build_parser().parse_args(
        MBPO_ARGS + ["--run_dir", os.path.join(run_dir, "mbpo")]))
    ctl = PDEModelBasedController(cfg)
    ctl.learn()
    out["mbpo"] = {name: _listed(getattr(ctl, name)) for name in
                   ("_collect_jit", "_world_jit", "_policy_jit", "_sur_eval_jit")}
    out["mbpo"]["_train_jit"] = _listed(ctl.trainer._train_jit)

    args = sac_train.build_parser().parse_args(
        SAC_ARGS + ["--run_dir", os.path.join(run_dir, "sac")])
    trainer = sac_train.SACTrainer(args)
    trainer.learn(MetricsLogger(args.run_dir, config=vars(args)))
    out["sac"] = {"_chunk_jit": _listed(trainer._chunk_jit)}

    n, fill = FIT["N"], np.asarray(FIT["fill"], np.int32)
    rep = R.create(len(fill), 16, 2, (1, n), (1, n), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    rep = rep.replace(obs_seq=jnp.asarray(rng.normal(size=rep.obs_seq.shape), jnp.float32),
                      actions=jnp.asarray(rng.uniform(-1, 1, rep.actions.shape), jnp.float32),
                      fill=jnp.asarray(fill))
    model = factories.make("KSAutoRegFullyConnectedLSTM", delta=0.25, N=n)
    tr = SurrogateTrainer(model, mse_loss, TrainConfig(**FIT["config"]))
    x = jnp.zeros((1, 2, 1, n), jnp.float32)
    train = jnp.asarray(np.asarray(FIT["train"], bool))
    tr.fit(tr.init(jax.random.PRNGKey(0), x, x), rep, train, ~train & (rep.fill > 0),
           Identity(), SampleTransform(), Scheduler.factory(FIT["curriculum"]), 0,
           jax.random.PRNGKey(1))
    out["fit"] = {"_train_jit": _listed(tr._train_jit)}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
