"""The offline CLIs of the port (``evaluation.generate`` and
``evaluation.evaluate``) on the CPU at a tiny size: the fold indices against
the JAX package's, the dataset's keys, dtypes and episode-major layout, and
``generate`` -> ``evaluate`` end to end for an AUTOREG and a LATENT factory
(files, keys, finite values).  A budget below 1 changes row masks, not array
shapes."""

import json
import math
import os

import numpy as np
import pytest
import torch

from pdecontrol_tpu.evaluation import evaluate as jevaluate
from pdecontrol_tpu.evaluation import generate as jgenerate
from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.evaluation import evaluate, generate
from pdecontrol_tpu_torch.train.schedulers import ConstantLengthScheduler, LinearScheduler

ENV = {"n": 16, "cfg_steps": 5, "t_max": 0.08, "transient_time": 0.5}  # 16-step episodes
TRAINING = {"tau": 2, "tbtt": 1000000, "batch_size": 4, "patience": 2, "max_epochs": 2}
BATTERY_KEYS = (
    {"MSE", "states", "outputs", "actions"}
    | {f"{m}{s}" for m in ("l1_loss", "l2_loss", "l1_loss_scaled", "l2_loss_scaled", "nrmse")
       for s in ("", "_rews")}
    | {f"{m}-derivative-{d}" for m in ("l1_loss_derivs", "l2_loss_derivs",
                                       "l1_loss_scaled_derivs", "l2_loss_scaled_derivs",
                                       "nrms_derivs") for d in range(3)}
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "ks.npz"
    torch.set_num_threads(1)
    assert generate.main(["--platform", "cpu", "--episodes", "6", "--output", str(path),
                          "--config", json.dumps({**ENV, "solver": "pallas"})]) == 0
    return path


@pytest.mark.parametrize("n, splits, seed", [(10, 5, 0), (7, 3, 1), (100, 5, 4), (3, 3, 0)])
def test_kfold_indices_equal_jax(n, splits, seed):
    ours, theirs = evaluate.kfold_indices(n, splits, seed), jevaluate.kfold_indices(
        n, splits, seed)
    assert len(ours) == len(theirs) == splits
    for (a_train, a_test), (b_train, b_test) in zip(ours, theirs):
        np.testing.assert_array_equal(a_train, b_train)
        np.testing.assert_array_equal(a_test, b_test)
    assert sorted(np.concatenate([test for _, test in ours])) == list(range(n))


def test_parsers_have_the_jax_flags():
    for ours, theirs in ((generate, jgenerate), (evaluate, jevaluate)):
        a = {x.dest: x.default for x in ours.build_parser()._actions}
        b = {x.dest: x.default for x in theirs.build_parser()._actions}
        assert a == b


def test_generated_dataset_layout(dataset):
    data = dict(np.load(dataset))
    assert set(data) == {"obs", "actions", "nxtobs", "rewards", "terminated", "truncated",
                         "steps"}
    shapes = {k: v.shape for k, v in data.items()}
    assert shapes == {"obs": (6, 16, 1, 16), "actions": (6, 16, 1, 4),
                      "nxtobs": (6, 16, 1, 16), "rewards": (6, 16), "terminated": (6, 16),
                      "truncated": (6, 16), "steps": (6, 16)}
    for k in ("obs", "actions", "nxtobs", "rewards"):
        assert data[k].dtype == np.float32 and np.isfinite(data[k]).all(), k
    assert data["steps"].dtype == np.int32 and data["terminated"].dtype == np.bool_
    # Episode-major: along axis 1 the next obs of step t is the obs of t + 1.
    np.testing.assert_array_equal(data["nxtobs"][:, :-1], data["obs"][:, 1:])
    np.testing.assert_array_equal(data["steps"], np.tile(np.arange(1, 17), (6, 1)))
    assert data["truncated"][:, -1].all() and not data["truncated"][:, :-1].any()
    assert not data["terminated"].any()
    assert np.abs(data["actions"]).max() <= 1 and data["actions"].std() > 0.3
    assert (data["rewards"] < 0).all()


def test_generate_burgers_in_process():
    data = generate.generate("BurgersEnv-v0", 3, {"n": 16, "cfg_steps": 5, "t_max": 0.04},
                             seed=1, device="cpu")
    assert data["obs"].shape == (3, 8, 1, 16) and np.isfinite(data["rewards"]).all()


@pytest.mark.parametrize("factory", ["KSAutoRegConvolutionalLSTM", "KSLatentLSTM"])
def test_generate_then_evaluate(dataset, tmp_path, factory):
    out = tmp_path / "eval"
    rc = evaluate.main([
        "--platform", "cpu", "--env_id", "KuramotoSivashinskyEnv-v0",
        "--env_config", json.dumps(ENV), "--data", str(dataset), "--factory", factory,
        "--target_length", "4", "--splits", "3", "--max_folds", "2",
        "--training", json.dumps(TRAINING),
        "--trainer", json.dumps({"gradient_clip_val": 0.5}),
        "--store", "--output", str(out),
    ])
    assert rc == 0
    summary = json.load(open(out / "summary.json"))
    assert [r["fold"] for r in summary] == [0, 1]
    for r in summary:
        assert set(r) == {"fold", "val_loss", "train_time", "train_steps", "MSE",
                          "nrmse_final", "l2_loss_scaled_final"}
        assert all(math.isfinite(r[k]) for k in ("val_loss", "MSE", "nrmse_final",
                                                 "l2_loss_scaled_final", "train_time"))
        assert r["train_steps"] >= 2
    with np.load(out / "fold0_metrics.npz") as fold:
        assert set(fold.files) == BATTERY_KEYS
        assert fold["nrmse"].shape == (6,)  # tau + target_length
        # Two test episodes of 16 steps, stride-2 windows of 6: 6 each.
        assert fold["states"].shape == (12, 6, 1, 16)
        assert fold["actions"].shape == (12, 6, 1, 4)
        assert all(np.isfinite(fold[k]).all() for k in fold.files)
        assert summary[0]["MSE"] == pytest.approx(float(fold["MSE"]))
    stored = torch.load(out / "fold0_model.pt", weights_only=True)
    assert set(stored) == {"state_dict", "oscaling", "undscaling", "factory"}
    assert stored["factory"] == factory
    assert set(stored["oscaling"]) == {"mean", "var", "count"}
    from pdecontrol_tpu_torch.models import factories

    factories.make(factory, delta=0.005, N=16).load_state_dict(stored["state_dict"],
                                                               strict=True)


def test_sub_budget_masks_not_shapes(dataset, tmp_path, monkeypatch):
    """--total restricts fold indices, not array shapes: a 0.5 budget over 6
    episodes folds over 3 of them while the replay keeps all 6 rows."""
    seen = {}
    real = evaluate.SurrogateTrainer.fit

    def spy(self, state, rep, train_mask, val_mask, *args, **kwargs):
        seen.update(rows=rep.num_rows, train=train_mask.clone(), val=val_mask.clone())
        return real(self, state, rep, train_mask, val_mask, *args, **kwargs)

    monkeypatch.setattr(evaluate.SurrogateTrainer, "fit", spy)
    out = tmp_path / "eval_budget"
    rc = evaluate.main([
        "--platform", "cpu", "--env_config", json.dumps(ENV), "--data", str(dataset),
        "--target_length", "4", "--splits", "3", "--max_folds", "1", "--total", "0.5",
        "--training", json.dumps(TRAINING), "--output", str(out),
    ])
    assert rc == 0
    summary = json.load(open(out / "summary.json"))
    assert len(summary) == 1 and np.isfinite(summary[0]["MSE"])
    assert seen["rows"] == 6 and seen["train"].shape == (6,)
    used = seen["train"] | seen["val"]
    assert int(used.sum()) == 2 and not used[3:].any()  # 3 episodes, 1 held out
    assert not os.path.exists(out / "fold0_model.pt")


def test_evaluate_raises_when_no_test_window_fits(dataset, tmp_path):
    with pytest.raises(ValueError, match="no test episode admits"):
        evaluate.main(["--platform", "cpu", "--env_config", json.dumps(ENV),
                       "--data", str(dataset), "--target_length", "4", "--splits", "3",
                       "--max_folds", "1", "--output", str(tmp_path / "o"),
                       "--training", json.dumps({**TRAINING, "tau": 13}),
                       "--curriculum", json.dumps({"scheduler": "ConstantLengthScheduler",
                                                   "length": 2})])


def test_curriculum_flag_honored():
    default = evaluate.make_curriculum("{}", 30)
    assert isinstance(default, ConstantLengthScheduler) and default() == 30
    cfg = {"scheduler": "LinearScheduler", "steptype": "epoch", "start": 0, "stop": 100,
           "vmin": 25, "vmax": 50}
    sched = evaluate.make_curriculum(json.dumps(cfg), 30)
    theirs = jevaluate.make_curriculum(json.dumps(cfg), 30)
    assert isinstance(sched, LinearScheduler)
    assert [sched(epoch=e) for e in (0, 50, 200)] == [theirs(epoch=e) for e in (0, 50, 200)]


def test_enumerate_windows_orders_rows_and_starts():
    rep = R.create(3, 8, 1, (1, 2), (1, 1))
    rep.fill[:] = torch.tensor([8, 5, 8], dtype=torch.int32)
    rep.steps[:] = torch.arange(8, dtype=torch.int32)[None] + 10 * torch.arange(3)[:, None]
    batch = R.enumerate_windows(rep, 4, stride=2,
                                rows_mask=torch.tensor([True, True, False]))
    assert batch.steps[:, 0].tolist() == [0, 2, 4, 10]
