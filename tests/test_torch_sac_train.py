"""The model-free SAC baseline CLI of the port (``pdecontrol_tpu_torch.sac.
train``) on the CPU at a tiny size, through the float32 plain solver and
through the bf16-limb solver; the same flags and the same log records as the
JAX CLI (``tests/test_sac_cli.py``)."""

import json
import math
import os

import pytest
import torch

from pdecontrol_tpu.sac import train as jtrain
from pdecontrol_tpu_torch.sac import train


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENV = {"n": 16, "cfg_steps": 5, "t_max": 0.04, "transient_time": 0.5}


def _args(run_dir, env_config):
    # tests/test_sac_cli.py, with the reset transient cut to 0.5 time units.
    return ["--platform", "cpu", "--run_dir", str(run_dir),
            "--env_config", json.dumps(env_config),
            "--num_envs", "2", "--total_timesteps", "40", "--learning_starts", "16",
            "--batch_size", "8", "--pool_size", "8", "--chunk", "5",
            "--eval_freq", "20", "--num_eval_episodes", "2"]


@pytest.mark.parametrize("solver", [
    {"solver": "xla"},
    {"solver": "pallas_packed", "pallas_precision": "bf16_3x"},
])
def test_sac_train_cli(tmp_path, solver):
    run_dir = tmp_path / "sac"
    assert train.main(_args(run_dir, {**ENV, **solver})) == 0
    records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    # 8 warmup steps of 2 envs, then chunks of 5 x 2 until 40: 26, 36, 46.
    assert [r["num_steps_sampled"] for r in records] == [26, 36, 46]
    # Evaluations at 16 (first chunk after the warmup), 36, 56, ...
    assert ["eval_return_mean" in r for r in records] == [True, True, False]
    for r in records:
        for k in ("collect_reward_mean", "sac_qf_loss"):
            assert math.isfinite(r[k]), (k, r)
        assert r["sac_qf_loss"] > 0
    assert all(math.isfinite(r["eval_return_mean"]) for r in records
               if "eval_return_mean" in r)


def test_sac_train_cli_has_the_jax_flags():
    ours = {a.dest: a.default for a in train.build_parser()._actions}
    theirs = {a.dest: a.default for a in jtrain.build_parser()._actions}
    assert set(theirs) <= set(ours)
    for dest, default in theirs.items():
        if dest != "platform":
            assert ours[dest] == default, dest


def test_trainer_fills_replay_and_updates(tmp_path):
    args = train.build_parser().parse_args(_args(tmp_path, {**ENV, "solver": "pallas_packed",
                                                           "pallas_precision": "bf16_4x"}))
    trainer = train.SACTrainer(args, device="cpu")
    assert trainer.env.solver == "pallas_packed"
    assert trainer.env.pallas_precision == "bf16_4x"
    rewards, qf = trainer.run_chunk(8, random=True, updates_per_step=0)
    assert rewards.shape == (8, 2) and float(qf) == 0.0
    assert int(trainer.replay.total_steps) == 16
    before = [p.clone() for p in trainer.sac_state.critic.parameters()]
    _, qf = trainer.run_chunk(3, random=False, updates_per_step=2)
    assert trainer.sac_state.updates == 6 and float(qf) > 0
    assert any(not torch.equal(a, b)
               for a, b in zip(before, trainer.sac_state.critic.parameters()))
    ev = trainer.evaluate()
    assert math.isfinite(ev["eval_return_mean"]) and ev["eval_return_std"] >= 0


def test_sac_train_debug_nans_is_not_ported(tmp_path):
    """The name is from when the flag raised "not yet ported".  It is ported
    now: a healthy run passes every check, the checker is made only when the
    flag asks for it, and anomaly detection is off again afterwards.  (What
    it catches: ``tests/test_torch_artifacts.py``.)"""
    assert train.main(_args(tmp_path, ENV) + ["--debug_nans"]) == 0
    assert not torch.is_anomaly_enabled()
    parse = train.build_parser().parse_args
    checked = train.SACTrainer(parse(_args(tmp_path, ENV) + ["--debug_nans"]), device="cpu")
    plain = train.SACTrainer(parse(_args(tmp_path, ENV)), device="cpu")
    assert checked.finite is not None and checked.sac.check is checked.finite
    assert plain.finite is None and plain.sac.check is None
