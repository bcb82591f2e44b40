"""The port's CLIs on the CPU at a tiny size for everything beside the main
model: ``learn()`` through ``mbrl.script`` with each of the four other
factories, on the Burgers env and with each physics loss; the SAC baseline
on Burgers; names that no registry holds; and a checkpoint round trip of a
LATENT and of a ``DelayCell`` controller (carries of other ranks than the
conv-LSTM's)."""

import json
import math
import os

import pytest
import torch

from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.mbrl.controller import ENVS
from pdecontrol_tpu_torch.models.surrogate import LATENT
from pdecontrol_tpu_torch.sac import train
from pdecontrol_tpu_torch.train import losses
from pdecontrol_tpu_torch.utils import checkpoint as C

from .test_torch_checkpoint import _assert_same, _controller
from .test_torch_sac_train import _args as sac_args
from .test_torch_slice import SMOKE_ARGS, _without

BURGERS = {"n": 16, "cfg_steps": 5, "t_max": 0.04}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The KS smoke arguments on the Burgers env, which takes no --solver and no
# reset transient.
BURGERS_ARGS = _without(SMOKE_ARGS, "--solver") + [
    "--env_id", "BurgersEnv-v0", "--env_config", json.dumps(BURGERS), "--reward_scale", "500"]


@pytest.mark.parametrize("flags", [
    ["--factory", "KSLatentLSTM"],
    ["--factory", "KSLatentConvolutionalLSTM"],
    ["--factory", "KSAutoRegFullyConnectedLSTM"],
    ["--factory", "KSDelayCNNSurrogateFactory"],
    ["--loss", "KSPhyPDELoss"],
    ["--loss", "PhyPDELoss", "--factory", "KSLatentLSTM"],
    BURGERS_ARGS,
    BURGERS_ARGS + ["--loss", "BurgersPhyPDELoss"],
    BURGERS_ARGS + ["--loss", "PhyPDELoss", "--factory", "KSDelayCNNSurrogateFactory"],
], ids=["KSLatentLSTM", "KSLatentConvolutionalLSTM", "KSAutoRegFullyConnectedLSTM",
        "KSDelayCNNSurrogateFactory", "KSPhyPDELoss", "PhyPDELoss-KS-latent", "BurgersEnv-v0",
        "BurgersPhyPDELoss", "PhyPDELoss-Burgers-delay"])
def test_learn_smoke_with_flag(flags, tmp_path):
    run_dir = str(tmp_path / "run")
    args = flags if flags[0] == SMOKE_ARGS[0] else SMOKE_ARGS + flags
    assert script.main(args + ["--run_dir", run_dir]) == 0
    records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["iteration"] for r in records if "iteration" in r] == list(range(8))
    assert sum("num_ensemble_updates" in r for r in records) == 2
    for key in ("train_loss", "val_loss", "sac_qf_loss", "sac_policy_loss",
                "eval_return_mean", "collect_reward_mean", "imagined_reward_mean",
                "surrogate_open_loop_mse", "reward_model_error"):
        vals = [r[key] for r in records if key in r]
        assert vals and all(math.isfinite(v) for v in vals), key
    cfg = json.load(open(os.path.join(run_dir, "config.json")))
    for flag, value in zip(flags[::2], flags[1::2]):
        if flag in ("--factory", "--loss", "--env_id"):
            assert cfg[flag[2:]] == value


def test_sac_cli_on_burgers(tmp_path):
    run_dir = tmp_path / "sac"
    assert train.main(sac_args(run_dir, BURGERS) + ["--env_id", "BurgersEnv-v0",
                                                    "--reward_scale", "500"]) == 0
    records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["num_steps_sampled"] for r in records] == [26, 36, 46]
    for r in records:
        assert math.isfinite(r["collect_reward_mean"]) and math.isfinite(r["sac_qf_loss"])
    assert any("eval_return_mean" in r for r in records)


@pytest.mark.parametrize("flags, error", [
    (["--factory", "NoSuchFactory"], "unknown factory"),
    (["--loss", "NoSuchLoss"], "unknown loss"),
    (["--env_id", "NoSuchEnv-v0"], "unknown env"),
])
def test_unknown_names_raise_as_in_the_jax_package(flags, error, tmp_path):
    with pytest.raises(KeyError, match=error):
        script.main(SMOKE_ARGS + ["--run_dir", str(tmp_path)] + flags)


def test_registries():
    assert sorted(ENVS) == ["BurgersEnv-v0", "KuramotoSivashinskyEnv-v0"]
    assert sorted(losses.REGISTRY) == ["BurgersPhyPDELoss", "KSPhyPDELoss", "MSELoss"]


@pytest.mark.parametrize("factory, carry_ranks", [("KSLatentLSTM", (2, 2)),
                                                  ("KSDelayCNNSurrogateFactory", (4, 4))])
def test_checkpoint_roundtrip_of_other_families(factory, carry_ranks, tmp_path):
    """Stop after 4 of 8 iterations, resume: the restored state equals the
    saved one, and the resumed run's records go on where the first stopped."""
    flags = ["--factory", factory, "--checkpoint_freq", "2"]
    first = _controller(tmp_path / "run", *flags, "--total_timesteps", "16")
    try:
        first.learn()
    finally:
        first.logger.finish()
    member = first.ensemble.members[0]
    assert (member.mode == LATENT) == (factory == "KSLatentLSTM")
    assert tuple(c.ndim for c in member.cell.init_carry(3)) == carry_ranks
    saved = C.to_host(C.controller_state(first))

    resumed = _controller(tmp_path / "run", *flags, "--resume")
    try:
        assert resumed.restored and resumed.iteration == 4
        _assert_same(C.to_host(C.controller_state(resumed)), saved)
        resumed.learn()
    finally:
        resumed.logger.finish()
    records = [json.loads(line)
               for line in open(os.path.join(tmp_path / "run", "metrics.jsonl"))]
    assert [r["iteration"] for r in records if "iteration" in r] == list(range(8))
    assert all(math.isfinite(r["sac_qf_loss"]) for r in records if "sac_qf_loss" in r)
