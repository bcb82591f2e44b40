"""The flagship surface around the port's training loop: plots and
evaluation artifacts (``--logging_freq``), the wall-time waterfall and the
run report over ``metrics.jsonl``, the profiler trace (``--profile_dir``)
and ``--debug_nans`` of both CLIs, all on the CPU at a tiny size."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.mbrl.agents import ActionRepeatAgent, RandomAgent
from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
from pdecontrol_tpu_torch.models.surrogate import PDESurrogate
from pdecontrol_tpu_torch.sac import train as sac_train
from pdecontrol_tpu_torch.sac.nets import GaussianPolicy, QNetwork
from pdecontrol_tpu_torch.utils import profiling, waterfall
from pdecontrol_tpu_torch.utils.asyncviz import BackgroundRenderer

from .test_torch_checkpoint import SMALL
from .test_torch_sac_train import ENV, _args as sac_args

N, EP, EPISODES, H = 16, 8, 2, 4  # grid, episode length, eval episodes, horizon


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """One CLI run of 8 iterations with plots and artifacts at every
    evaluation and retrain, and a trace of iteration 1."""
    d = tmp_path_factory.mktemp("artifacts") / "run"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = script.main(SMALL + ["--run_dir", str(d), "--logging_freq", "1",
                                  "--profile_dir", str(d / "profile")])
    finally:
        torch.set_num_threads(n)
    assert rc == 0
    return d


def test_viz_smoke():
    from pdecontrol_tpu_torch.viz import plots

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(20, 1, 16))
    pred = obs + 0.1 * rng.normal(size=obs.shape)
    actions = rng.normal(size=(20, 1, 4))
    rewards = rng.normal(size=(20,))

    img = plots.pdeplot(obs, pred, actions, rewards, rewards * 1.1)
    assert img.size[0] > 100
    assert plots.spatial({"outdeltas": obs, "deltas": pred}).size[0] > 100
    assert plots.epplot(obs, actions[:, 0], rewards).size[0] > 100
    assert plots.hstepplot(np.abs(rng.normal(size=10))).size[0] > 100
    assert plots.trisurf(obs, dt=0.25, length=22.0).size[0] > 100


def test_importing_the_controller_needs_no_matplotlib():
    code = ("import sys; import pdecontrol_tpu_torch.mbrl.controller, "
            "pdecontrol_tpu_torch.mbrl.script, pdecontrol_tpu_torch.utils.asyncviz; "
            "sys.exit(int('matplotlib' in sys.modules or 'PIL' in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=120)
    assert done.returncode == 0


@pytest.mark.parametrize("name, shapes", [
    # pdecontrol_tpu/mbrl/controller.py::_save_eval_artifact: episode-major.
    ("eval_0.npz", {"obs": (EPISODES, EP, 1, N), "actions": (EPISODES, EP, 1, 4),
                    "rewards": (EPISODES, EP)}),
    ("eval_4.npz", {"obs": (EPISODES, EP, 1, N), "actions": (EPISODES, EP, 1, 4),
                    "rewards": (EPISODES, EP)}),
    # ::_save_surrogate_artifact: world space, from tau on.
    ("surrogate_eval_4.npz", {"states": (H, 1, N), "outputs": (H, 1, N),
                              "actions": (H, 1, N), "rewards": (H,), "rpred": (H,),
                              "hstep_mse": (H,)}),
])
def test_cli_run_writes_the_evaluation_artifacts(run_dir, name, shapes):
    with np.load(run_dir / "evaluation" / name) as z:
        assert set(z.files) == set(shapes)
        for key, shape in shapes.items():
            assert z[key].shape == shape, key
            assert z[key].dtype == np.float32 and np.isfinite(z[key]).all(), key
        if "hstep_mse" in shapes:
            np.testing.assert_allclose(
                z["hstep_mse"], ((z["outputs"] - z["states"]) ** 2).mean((1, 2)), rtol=1e-5)
            records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
            np.testing.assert_allclose(records[4]["surrogate_open_loop_mse"],
                                       z["hstep_mse"].mean(), rtol=1e-5)


def test_cli_run_writes_the_plots(run_dir):
    from PIL import Image

    # Retrains at iterations 0 and 4 (train and val windows); the one
    # surrogate evaluation that finds a complete episode is iteration 4's.
    want = {f"{stage}_{kind}_iter{it}.png" for stage in ("train", "val")
            for kind in ("vis", "spatial") for it in (0, 4)}
    want |= {"surrogate_iter4.png", "hstep_iter4.png"}
    assert set(os.listdir(run_dir / "plots")) == want
    for name in want:
        with Image.open(run_dir / "plots" / name) as img:
            assert img.size[0] > 100 and img.size[1] > 100, name


def test_logging_freq_zero_writes_nothing(tmp_path):
    d = tmp_path / "run"
    assert script.main(SMALL + ["--run_dir", str(d), "--logging_freq", "0",
                                "--total_timesteps", "12"]) == 0
    assert sorted(os.listdir(d)) == ["config.json", "metrics.jsonl"]


def test_waterfall_closes_on_a_port_run(run_dir):
    out = waterfall.analyze(str(run_dir / "metrics.jsonl"))
    records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    assert abs(out["residual_s"]) <= 0.1  # rounded to 0.1 s
    assert out["total_s"] == round(records[-1]["time"], 1)
    assert out["retrain"]["n"] == 2 and out["steady"]["n"] + out["eval"]["n"] == 6
    sub = out["retrain"]["surrogate_sub"]
    # The default route's fit timers (the lock-step fit).
    assert all({"t_fit_prep", "t_fit_dispatch", "t_fit_ready"} <= set(r)
               for r in records if "t_surrogate" in r)
    fit = sum(r.get(f, 0) for r in records for f in waterfall.FIT_FIELDS)
    assert fit > 0
    assert math.isclose(sum(sub.get(f, 0) for f in waterfall.FIT_FIELDS), fit,
                        abs_tol=0.11)
    # The fit's own residual closes on the port's timers (not None, small).
    assert out["retrain"]["fit_internal_residual_s"] is not None
    assert abs(out["retrain"]["fit_internal_residual_s"]) <= 0.2
    assert abs(out["retrain"]["surrogate_residual_s"]) <= 0.5


def test_report_renders_a_port_run(run_dir, tmp_path):
    from pdecontrol_tpu_torch.viz import report

    summary = report.render(str(run_dir), str(tmp_path / "out"))
    assert math.isfinite(summary["eval_return_last"])
    assert "summary.json" in os.listdir(tmp_path / "out")
    assert any(f.endswith(".png") for f in os.listdir(tmp_path / "out"))


def test_profile_dir_writes_a_trace_of_iteration_1(run_dir):
    """The trace of iteration 1, with the loop's spans among its host
    events, and beside it the spans file: the ring of host spans and the
    iteration's four device stamps, in order, inside its dispatch."""
    files = sorted(os.listdir(run_dir / "profile"))
    traces = [f for f in files if f.startswith("trace-") and f.endswith(".json")]
    spans = [f for f in files if f.startswith("spans-") and f.endswith(".jsonl")]
    assert len(traces) == len(spans) == 1 and len(files) == 2, files
    events = json.load(open(run_dir / "profile" / traces[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert len(events) > 1000
    assert "aten::addmm" in names  # the SAC updates of the traced iteration
    assert {"iteration", "iteration.dispatch"} <= names  # the spans, under the profiler
    lines = [json.loads(line) for line in open(run_dir / "profile" / spans[0])]
    assert lines[0]["clock"] == "perf_counter_ns" and lines[0]["device_offset_ns"] == 0
    ring = [x for x in lines if "span" in x]
    assert {"iteration", "iteration.dispatch", "retrain", "fit.epoch"} <= {x["span"] for x in ring}
    assert all(x["start_ns"] <= x["end_ns"] for x in ring)
    stamps = [(x["stamp"], x["host_ns"]) for x in lines if "stamp" in x]
    assert [name for name, _ in stamps] == ["start", "collect", "imagine", "policy"]
    assert [t for _, t in stamps] == sorted(t for _, t in stamps)
    dispatch = [x for x in ring if x["span"] == "iteration.dispatch"][-1]
    assert dispatch["start_ns"] <= stamps[0][1] and stamps[-1][1] <= dispatch["end_ns"]


def test_trace_reports_its_path(tmp_path):
    with profiling.trace(str(tmp_path / "p")) as result:
        torch.ones(8).sum()
        assert result == {}
    assert os.path.exists(result["path"])
    assert result["wall_s"] > 0 and result["export_s"] >= 0


def test_background_renderer_survives_a_failed_job(capsys):
    viz = BackgroundRenderer()
    done = []

    def broken():
        raise ImportError("No module named 'matplotlib'")

    viz.submit(broken)
    viz.submit(lambda: done.append(1))
    viz.drain()
    assert done == [1]
    assert "[viz] background render failed" in capsys.readouterr().out


def test_artifacts_without_matplotlib(tmp_path, monkeypatch, capsys):
    """A host without matplotlib still gets the npz files; the renders fail
    with a warning and never stop the run."""
    import pdecontrol_tpu_torch.viz as viz_package

    monkeypatch.setitem(sys.modules, "pdecontrol_tpu_torch.viz.plots", None)
    monkeypatch.delattr(viz_package, "plots", raising=False)
    args = script.build_parser().parse_args(
        SMALL + ["--run_dir", str(tmp_path / "run"), "--logging_freq", "1"])
    ctl = PDEModelBasedController(script.config_from_args(args), device="cpu")
    ctl.collect(2 * EP + 1, random=True)
    state = ctl.gen.get_state()
    ctl.update_delta_transform()
    ctl.update_surrogates()  # queues the four retrain plots
    ctl.evaluate_policy()
    assert ctl.evaluate_surrogate()
    ctl.viz.drain()
    ctl.logger.finish()
    assert not torch.equal(ctl.gen.get_state(), state)  # the draws were made
    assert sorted(os.listdir(tmp_path / "run" / "evaluation")) == [
        "eval_0.npz", "surrogate_eval_0.npz"]
    assert not os.path.exists(tmp_path / "run" / "plots") \
        or not os.listdir(tmp_path / "run" / "plots")
    assert capsys.readouterr().out.count("[viz] background render failed") == 3


def test_agents():
    gen = torch.Generator().manual_seed(3)
    agent = RandomAgent((1, 4), low=-0.5, high=2.0)
    obs = torch.zeros(5, 1, N, dtype=torch.float64)
    a = agent.select_action(None, obs, gen)
    assert a.shape == (5, 1, 4) and a.dtype == torch.float64
    assert (a >= -0.5).all() and (a < 2.0).all()
    u = torch.rand((5, 1, 4), generator=torch.Generator().manual_seed(3),
                   dtype=torch.float64)
    assert torch.equal(a, -0.5 + u * 2.5)
    seq = torch.arange(2 * 3 * 1 * 4, dtype=torch.float32).reshape(2, 3, 1, 4)
    assert torch.equal(ActionRepeatAgent(seq).action_at(2), seq[:, 2])
    with pytest.raises(ValueError):
        ActionRepeatAgent(seq[0])


# ------------------------------------------------------------- --debug_nans
def _poison(monkeypatch, cls, attr):
    """Plant a NaN in one weight of every ``cls`` built from here on."""
    real = cls.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        module = self
        for name in attr.split("."):
            module = getattr(module, name)
        with torch.no_grad():
            module.weight.view(-1)[0] = float("nan")

    monkeypatch.setattr(cls, "__init__", init)


@pytest.mark.parametrize("cls, attr, phase", [
    (GaussianPolicy, "mean", r"non-finite field in collect \(env step\) at iteration 0"),
    (PDESurrogate, "state_decoder.blocks.0",
     r"non-finite train_loss in the surrogate fit \(TBPTT step\) at iteration 0"),
    (QNetwork, "linear1", r"non-finite qf_loss in the SAC update at iteration 0"),
])
def test_debug_nans_names_the_phase(tmp_path, monkeypatch, capsys, cls, attr, phase):
    import re

    _poison(monkeypatch, cls, attr)
    args = SMALL + ["--run_dir", str(tmp_path / "run"), "--total_timesteps", "12",
                    "--logging_freq", "0"]
    assert script.main(args + ["--debug_nans"]) == 1
    err = capsys.readouterr().err
    assert "FloatingPointError" in err and re.search(phase, err), err[-2000:]
    assert not torch.is_anomaly_enabled()

    # Without the flag no check runs: the NaN spreads and nothing raises.
    assert script.main(args) == 0
    assert "FloatingPointError" not in capsys.readouterr().err
    records = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert any(isinstance(v, float) and math.isnan(v) for r in records for v in r.values())


def test_debug_nans_checks_the_imagined_steps(tmp_path):
    args = script.build_parser().parse_args(SMALL + ["--run_dir", str(tmp_path / "run")])
    ctl = PDEModelBasedController(script.config_from_args(args), device="cpu",
                                  debug_nans=True)
    ctl.logger.finish()
    ctl.collect(EP, random=True)
    ctl.finite.iteration = 3
    ctl.imagine(2)  # finite: passes
    with torch.no_grad():
        ctl.ensemble.members[0].state_decoder.blocks[0].weight.view(-1)[0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"non-finite obs in imagine \(world-model step\) at iteration 3"):
        ctl.imagine(2)


@pytest.mark.parametrize("cls, attr, phase", [
    (GaussianPolicy, "mean", r"non-finite field in collect \(env step\) at iteration 16"),
    (QNetwork, "linear1", r"non-finite qf_loss in the SAC update at iteration 16"),
])
def test_sac_train_debug_nans(tmp_path, monkeypatch, cls, attr, phase):
    _poison(monkeypatch, cls, attr)
    args = sac_args(tmp_path / "sac", {**ENV, "solver": "xla"})
    with pytest.raises(FloatingPointError, match=phase):
        sac_train.main(args + ["--debug_nans"])
    assert not torch.is_anomaly_enabled()
    assert sac_train.main(args) == 0  # unchecked without the flag
