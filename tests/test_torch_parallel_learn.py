"""The controller on a 2x2 mesh of four rank processes on the CPU (gloo,
a rendezvous file, a time limit each; ``tests/torch_mesh_ranks.py``)
against the port's one-process run of the same config:

  * ``collect(6, random=True)`` at the tolerance of
    ``tests/test_parallel.py:167-199``, and a full ``learn()`` on that
    file's keys at 2e-4 / 1e-7 (``:203-267``); the replicated state equal
    on every rank;
  * files on the primary rank only, and every rank's restore of the
    primary's last snapshot;
  * a resume under the mesh, which continues the primary's stream.
"""

import json
import os

import numpy as np
import pytest
import torch

from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
from tests.test_torch_parallel import run_ranks
from tests.torch_mesh_ranks import RESUME_TIMESTEPS, controller_config

# tests/test_parallel.py's keys of the full-iteration equivalence.
KEYS = ["collect_reward_mean", "imagined_reward_mean", "train_loss", "val_loss",
        "sac_qf_loss", "sac_policy_loss", "eval_return_mean", "surrogate_open_loop_mse",
        "reward_model_error", "num_ensemble_updates", "horizon"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def controllers(tmp_path_factory):
    """The controller at 2x2 in four rank processes, and at 1x1 here:
    ``collect(6, random=True)``, ``learn()``, and a resume."""
    out = tmp_path_factory.mktemp("controller")
    run_ranks("controller", out)
    ranks = [json.load(open(out / f"controller{i}.json")) for i in range(4)]

    def make(run_dir, **changes):
        return PDEModelBasedController(controller_config(str(run_dir), **changes),
                                       device="cpu")

    ctl = make(out / "single_collect", checkpoint_freq=0)
    rewards, _ = ctl.collect(6, random=True)
    single = {"rewards": rewards.numpy(), "obs_seq": ctl.replay.obs_seq.numpy()}
    ctl.logger.finish()
    first = make(out / "single")
    first.learn()
    first.logger.finish()
    resumed = make(out / "single", total_timesteps=RESUME_TIMESTEPS, resume=True)
    resumed.learn()
    resumed.logger.finish()
    return out, ranks, single


def test_mesh_collect_equals_one_process(controllers):
    out, _, single = controllers
    mesh = np.load(out / "collect.npz")
    for k in ("rewards", "obs_seq"):
        np.testing.assert_allclose(mesh[k], single[k], rtol=1e-6, atol=1e-8, err_msg=k)


def test_mesh_learn_equals_one_process(controllers):
    """Every record of the 2x2 run (the resumed one included) against
    1x1 on the JAX test's keys at its tolerance; the replicated state is
    equal on every rank."""
    out, ranks, _ = controllers
    mesh, single = _stream(out / "run_p0"), _stream(out / "single")
    assert len(mesh) == len(single) == 4
    for a, b in zip(mesh, single):
        for k in KEYS:
            assert (k in a) == (k in b), k
            if k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-7,
                                           err_msg=f"{k} diverged between 1x1 and 2x2")
    for k in ("iteration", "params", "generator"):
        assert len({json.dumps(r[k]) for r in ranks}) == 1, k


def test_files_on_the_primary_only_and_restore_on_every_rank(controllers):
    out, ranks, _ = controllers
    assert [r["primary"] for r in ranks] == [True, False, False, False]
    assert {"metrics.jsonl", "config.json", "checkpoints/2.pt",
            "checkpoints/3.pt"} <= set(ranks[0]["files"])
    for r in ranks[1:]:
        assert r["files"] == []
    for i in range(1, 4):
        assert not (out / f"run_p{i}").exists()
    assert all(r["restore_ok"] for r in ranks)


def test_resume_under_the_mesh_continues_the_stream(controllers):
    out, ranks, _ = controllers
    assert all(r["restored"] and r["iteration"] == 4 for r in ranks)
    mesh, single = _stream(out / "run_p0"), _stream(out / "single")
    assert [r.get("iteration") for r in mesh if "iteration" in r] == list(range(4))
    assert mesh[-1]["_step"] == single[-1]["_step"] == len(mesh) - 1
    for a, b in zip(mesh[3:], single[3:]):
        for k in KEYS:
            if k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-7, err_msg=k)
