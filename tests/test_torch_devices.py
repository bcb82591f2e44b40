"""The port's entry points run on the GPU unless asked for the CPU: without
a CUDA device, the MBPO CLI, the SAC trainer, the attractor gate and the
offline ``generate`` / ``evaluate`` CLIs raise (naming ``--platform cpu``)
instead of carrying on on the CPU.  That they run with ``--platform cpu`` is
shown by their CLI tests
(``tests/test_torch_{slice,sac_train,gate,evaluation}.py``)."""

import pytest
import torch

import numpy as np

from pdecontrol_tpu_torch.evaluation import bf16_gate, evaluate, generate
from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.sac import train
from pdecontrol_tpu_torch.utils import device as D

from .test_torch_sac_train import ENV, _args as sac_args
from .test_torch_slice import SMOKE_ARGS, _without


def _mbpo(platform, tmp_path):
    return script.main(_without(SMOKE_ARGS, "--platform") + platform
                       + ["--run_dir", str(tmp_path)])


def _sac(platform, tmp_path):
    args = train.build_parser().parse_args(
        _without(sac_args(tmp_path, ENV), "--platform") + platform)
    if not platform:  # the library call, with no device
        return train.SACTrainer(args)
    return train.SACTrainer(args, device=D.platform_device(args.platform))


def _gate(platform, tmp_path):
    return bf16_gate.main(["--batch", "2", "--transient", "1", "--periods", "2",
                           "--output", str(tmp_path / "verdict.json")] + platform)


def _generate(platform, tmp_path):
    return generate.main(["--episodes", "2", "--output", str(tmp_path / "verdict.json"),
                          "--config", '{"n": 16, "cfg_steps": 5, "t_max": 0.04, '
                          '"transient_time": 0.5}'] + platform)


def _evaluate(platform, tmp_path):
    data = {"obs": np.zeros((3, 8, 1, 16), np.float32),
            "actions": np.zeros((3, 8, 1, 4), np.float32)}
    np.savez(tmp_path / "data.npz", **data)
    return evaluate.main(["--data", str(tmp_path / "data.npz"),
                          "--output", str(tmp_path / "verdict.json")] + platform)


@pytest.mark.parametrize("platform", [[], ["--platform", "gpu"], ["--platform", "cuda"]],
                         ids=["default", "gpu", "cuda"])
@pytest.mark.parametrize("entry", [_mbpo, _sac, _gate, _generate, _evaluate],
                         ids=["mbpo", "sac", "gate", "generate", "evaluate"])
def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path, entry, platform):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        entry(platform, tmp_path)
    assert not (tmp_path / "verdict.json").exists()


def test_entry_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert D.entry_device("cpu") == torch.device("cpu")
    assert D.entry_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        D.entry_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert D.entry_device() == torch.device("cuda")
    assert [D.platform_device(p) for p in (None,) + D.PLATFORMS] == [None, "cpu", "cuda",
                                                                     "cuda"]
