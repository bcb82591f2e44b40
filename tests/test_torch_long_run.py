"""What only a long MBPO run reaches, at a tiny size on the CPU: the horizon
climbing from 3 to 7, a world replay that wraps, and a retrain in which
members stop at different epochs (``chip_smoke.py`` phase 19 runs the same
changes at the flagship's widths on the card).  The default route (the
fused iteration, the lock-step fit) and ``--no_fuse_iteration --no_fuse_fit``
must agree in every field of every record that does not read the clock, in
each retrain's steps per member, and in the members' parameters and Adam
state; the port's horizons over the flagship's first 250 iterations must be
the JAX package's."""

import gzip
import json
import math
import os

import numpy as np
import pytest
import torch

from pdecontrol_tpu.train.schedulers import Scheduler as JScheduler
from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
from pdecontrol_tpu_torch.viz import long_run

from .test_torch_slice import SMOKE_ARGS

ITERATIONS = 10
HORIZONS = [3, 3, 4, 4, 5, 5, 6, 6, 7, 7]
# runscripts/mbpo_ks.sh's --rollout_length_schedule.
FLAGSHIP_SCHEDULE = {"scheduler": "LinearScheduler", "steptype": "iteration",
                     "start": 0, "stop": 200, "vmin": 3, "vmax": 7}


def _with(args, **changes):
    out = list(args)
    for flag, value in changes.items():
        out[out.index("--" + flag) + 1] = value
    return out


# SMOKE_ARGS (2 envs, 2 samples an iteration) for 10 iterations with
# retrains at 0 and 5, the horizon climbing 3 -> 7 over iterations 0-8, a
# world replay of 2 iterations' rollouts (8 rows of the 4 an iteration
# adds, wrapped in iteration 2), and patience 2 / 1 after min_steps 2 / 1,
# below max_steps 12.
ARGS = _with(
    SMOKE_ARGS, total_timesteps=str(8 + 2 * ITERATIONS), surrogate_train_freq="10",
    rollout_length_schedule=json.dumps({"scheduler": "LinearScheduler",
                                        "steptype": "iteration", "start": 0, "stop": 8,
                                        "vmin": 3, "vmax": 7}),
    training=json.dumps({"tau": 2, "initial": {"tbtt": 4, "patience": 2, "batch_size": 4},
                         "iterations": {"tbtt": 4, "patience": 1, "batch_size": 4}}),
    trainer=json.dumps({"initial": {"min_steps": 2, "max_steps": 12},
                        "iterations": {"min_steps": 1, "max_steps": 12}}),
    num_dynamics_models="3",
) + ["--model_buffer_store_iterations", "2", "--logging_freq", "0"]
ROUTES = {"default": [], "unfused": ["--no_fuse_iteration", "--no_fuse_fit"]}
# Fields of a record that read the host's clock or its garbage collector.
WALL_CLOCK = ("start", "time", "_time", "env_steps_per_sec", "gc_max_pause", "n_gc2")


def _controller(run_dir, *flags):
    args = script.build_parser().parse_args(ARGS + ["--run_dir", str(run_dir)] + list(flags))
    return PDEModelBasedController(script.config_from_args(args), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each route's controller after ``learn()``, its records and each
    retrain's steps per member."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, flags in ROUTES.items():
            run_dir = tmp_path_factory.mktemp(name)
            ctl = _controller(run_dir, *flags)
            fits, update = [], ctl.update_surrogates

            def noted_update(ctl=ctl, fits=fits, update=update):
                before = ctl.fit_state.global_step.tolist()
                logs = update()
                fits.append([b - a for a, b in zip(before, ctl.fit_state.global_step.tolist())])
                return logs

            ctl.update_surrogates = noted_update
            try:
                ctl.learn()
            finally:
                ctl.logger.finish()
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            out[name] = (ctl, records, fits)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_horizon_climbs_and_world_replay_wraps(runs, route):
    ctl, records, fits = runs[route]
    assert ctl.config.fuse_iteration == (route == "default")
    assert [r["horizon"] for r in records] == HORIZONS
    assert ctl.world_replay.num_rows == 8
    # The first 4 rows hold the rollout batch's first episodes; each
    # iteration claims 4 more.
    assert int(ctl.world_replay.next_row) == 4 + 4 * ITERATIONS > 8
    assert len(fits) == 2  # retrains at iterations 0 and 5


def test_a_member_stops_before_the_others(runs):
    _, _, fits = runs["default"]
    assert any(min(steps) < max(steps) for steps in fits), fits
    assert all(max(steps) <= 12 for steps in fits)


def test_routes_agree_while_the_long_run_paths_run(runs):
    """Every non-clock field, the steps per member, the world replay and the
    members' parameters and Adam state: identical."""
    (a, ra, fa), (b, rb, fb) = runs["default"], runs["unfused"]

    def strip(record):
        return {k: v for k, v in record.items()
                if k not in WALL_CLOCK and not k.startswith("t_")}

    assert [strip(r) for r in ra] == [strip(r) for r in rb]
    assert fa == fb
    assert "t_fit_ready" in ra[0] and "t_fit_val" in rb[0]  # the two fit routes
    for k in ("params", "exp_avg", "exp_avg_sq", "count", "global_step"):
        np.testing.assert_array_equal(getattr(a.fit_state, k).numpy(),
                                      getattr(b.fit_state, k).numpy())
    for f in ("obs_seq", "rewards", "fill", "next_row"):
        np.testing.assert_array_equal(getattr(a.world_replay, f).numpy(),
                                      getattr(b.world_replay, f).numpy())


def test_flagship_horizons_match_jax(tmp_path):
    """The port's controller, built with the flagship's schedule, picks the
    JAX package's horizon at each of the first 250 iterations (3 to 7, then
    7)."""
    args = _with(ARGS, rollout_length_schedule=json.dumps(FLAGSHIP_SCHEDULE))
    cfg = script.config_from_args(script.build_parser().parse_args(
        args + ["--run_dir", str(tmp_path)]))
    ctl = PDEModelBasedController(cfg, device="cpu")
    ctl.logger.finish()
    jax_schedule = JScheduler.factory(FLAGSHIP_SCHEDULE)
    ours = [int(ctl.schedule(iteration=i)) for i in range(250)]
    assert ours == [int(jax_schedule(iteration=i)) for i in range(250)]
    assert ours[0] == 3 and ours[199] == 6 and ours[200:] == [7] * 50
    assert [ours.index(h) for h in range(3, 8)] == [0, 50, 100, 150, 200]


def test_long_run_report_reads_a_run(tmp_path):
    """``viz/long_run.py`` on a made-up run: a retrain with an evaluation
    at iteration 0, pipelined iterations (one capturing), a second retrain;
    its summary is ``viz/report.py``'s, read from ``metrics.jsonl.gz``."""
    recs = [
        {"iteration": 0, "num_steps_sampled": 5000, "horizon": 3, "time": 10.0,
         "t_fit_total": 12.0, "epochs": 90, "steps": 270, "t_surrogate": 12.5,
         "eval_return_mean": -600.0, "t_capture": 4.0, "graph_pool_mb": 39.8},
        {"iteration": 1, "num_steps_sampled": 5010, "horizon": 3, "time": 11.0,
         "t_dispatch": 0.2, "t_ready": 0.01, "t_capture": 3.6},
        {"iteration": 2, "num_steps_sampled": 5020, "horizon": 4, "time": 11.3,
         "t_dispatch": 0.25, "t_ready": 0.2},
        {"iteration": 3, "num_steps_sampled": 5030, "horizon": 4, "time": 11.7,
         "t_dispatch": 0.25, "t_ready": 0.3},
        {"iteration": 4, "num_steps_sampled": 15000, "horizon": 7, "time": 20.0,
         "t_fit_total": 2.0, "epochs": 10, "steps": 60, "t_surrogate": 2.1,
         "eval_return_mean": -150.0},
        {"iteration": 5, "num_steps_sampled": 25000, "horizon": 7, "time": 30.0,
         "t_fit_total": 4.0, "epochs": 20, "steps": 80, "t_surrogate": 4.1,
         "eval_return_mean": -170.0},
    ]
    with gzip.open(tmp_path / "metrics.jsonl.gz", "wt") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    log = tmp_path / "out.log"
    log.write_text("[memory] iteration 0: peak allocated 1724.9 MB, reserved 1713.4 MB\n"
                   '[rank] {"K1": 42320, "world_rows": [450100, 30000]}\n')
    out = long_run.report(str(tmp_path), str(log))
    s = out["summary"]
    assert (s["iterations"], s["env_steps"], s["wall_time_s"]) == (5, 25000, 30.0)
    assert (s["eval_return_first"], s["eval_return_best"], s["eval_return_last"]) == \
        (-600.0, -150.0, -170.0)
    assert s["in_band"]
    assert out["eval_at"] == {10000: -600.0, 20000: -150.0, 30000: -170.0}
    h = out["horizons"]
    assert h[3] == {"count": 0, "median": None, "min": None, "max": None,
                    "wall": {"count": 0, "median": None, "min": None, "max": None},
                    "captured": [0.21]}
    assert (h[4]["count"], h[4]["median"], h[4]["max"]) == (2, 0.5, 0.55)
    assert h[4]["wall"]["count"] == 1 and h[4]["wall"]["median"] == pytest.approx(0.4)
    r = out["retrains"]
    assert r["count"] == 3 and r["first"]["steps"] == 270
    assert r["later_median"]["t_fit_total"] == 3.0 and r["later_range"]["epochs"] == [10, 20]
    assert [c["iteration"] for c in out["captures"]] == [0, 1]
    assert out["memory"] == {0: {"peak_allocated_mb": 1724.9, "reserved_mb": 1713.4}}
    assert out["rank"]["K1"] == 42320


# The study's comparison (``long_run.compare``) on made-up streams.

def _write_stream(run_dir, evals, times=None):
    """A run's ``metrics.jsonl.gz`` with an evaluation at each (step,
    return) of ``evals``."""
    run_dir.mkdir(parents=True)
    times = times or [float(i) for i in range(len(evals))]
    with gzip.open(run_dir / "metrics.jsonl.gz", "wt") as f:
        for (step, value), t in zip(evals, times):
            f.write(json.dumps({"num_steps_sampled": step, "eval_return_mean": value,
                                "time": t}) + "\n")


def _mbpo(mean, best=None):
    """Evaluations at 9,500 ... 49,500 steps whose mark mean is ``mean``,
    and one of ``best`` between two marks."""
    evals = [(m - 500, mean + d) for m, d in zip(long_run.MARKS, (-40, -20, 0, 20, 40))]
    return sorted(evals + [(45_000, best)]) if best is not None else evals


def test_sac_first_reach_and_a_stream_that_never_reaches():
    recs = [{"num_steps_sampled": s, "eval_return_mean": v} for s, v in
            [(6000, -500.0), (15000, -200.0), (25000, -150.0), (35000, -160.0)]]
    recs.insert(1, {"num_steps_sampled": 7000, "collect_reward_mean": -1.0})
    assert long_run.first_reach(recs, -160.0) == 25000
    assert long_run.first_reach(recs, -500.0) == 6000
    assert long_run.first_reach(recs, -100.0) is None
    out = long_run._sac(recs, {"a": -155.0, "b": -120.0}, -155.0)
    assert (out["first_reach"], out["ratio"]) == (25000, 0.5)
    assert out["first_reach_by_run"] == {"a": 25000, "b": None}
    assert (out["eval_at_50k"], out["best"], out["last"]) == (-160.0, -150.0, -160.0)
    never = long_run._sac(recs, {"a": -100.0}, -100.0)
    assert never["first_reach"] is None and never["ratio"] is None


@pytest.mark.parametrize("n", [1, 3, 5])
def test_permutation_p_when_every_port_mean_lies_under_every_jax_mean(n):
    port = [-260.0, -265.0, -270.0, -275.0]
    jax = [-230.0 - i for i in range(n)]
    p, splits = long_run.permutation_p(port, jax)
    assert splits == math.comb(4 + n, 4)
    assert p == pytest.approx(1 / math.comb(4 + n, 4))
    # Above every JAX mean: every split's mean is at most the port's.
    assert long_run.permutation_p([-200.0] * 4, jax)[0] == 1.0


def test_permutation_p_counts_ties():
    # Four of {0, 0, 0, 1, 1, 1}: 12 of the 15 splits hold at most two 1s,
    # and so a mean of at most the observed 0.5.
    assert long_run.permutation_p([0.0, 0.0, 1.0, 1.0], [0.0, 1.0]) == (0.8, 15)
    assert long_run.permutation_p([-1.0] * 4, [-1.0] * 3) == (1.0, 35)


def test_jax_selection_takes_distinct_flagship_streams_and_fails_without_one(tmp_path):
    _write_stream(tmp_path / "ks50k", _mbpo(-226.0))
    _write_stream(tmp_path / "ks50k_r3", _mbpo(-228.0))
    _write_stream(tmp_path / "ks50k_r3b", _mbpo(-228.0))
    _write_stream(tmp_path / "ks50k_bf16", _mbpo(-249.0))
    # Resumed past 50k: its clock restarts and the repeated warmup
    # evaluation is not the run's.
    _write_stream(tmp_path / "ks50k_r2", _mbpo(-237.0) + [(50_000, -900.0)],
                  times=[1.0, 2.0, 3.0, 4.0, 5.0, 0.5])
    taken, left_out = long_run.jax_flagship_runs(str(tmp_path))
    assert list(taken) == ["ks50k", "ks50k_r2", "ks50k_r3"]
    assert left_out == {"ks50k_bf16": long_run.JAX_OTHER_CONFIG["ks50k_bf16"],
                        "ks50k_r3b": "the same eval stream as ks50k_r3"}
    assert long_run.mark_mean(taken["ks50k_r2"]) == pytest.approx(-237.0)
    (tmp_path / "ks50k_seed9").mkdir()
    with pytest.raises(FileNotFoundError, match="ks50k_seed9"):
        long_run.jax_flagship_runs(str(tmp_path))


def test_compare_reads_the_study(tmp_path, monkeypatch):
    """Port and JAX side by side: each channel's first-reach step, the
    pairs beside their limits, and the lag test's p and verdict."""
    port = {"torch_ks50k": -258.0, "torch_ks50k_seed1": -267.0,
            "torch_ks50k_seed2": -262.0, "torch_ks50k_seed3": -255.0}
    for name, mean in port.items():
        _write_stream(tmp_path / name, _mbpo(mean, best=-160.0 - len(name)))
    for name, mean in {"ks50k": -226.0, "ks50k_seed1": -240.0}.items():
        _write_stream(tmp_path / name, _mbpo(mean, best=-154.0))
    _write_stream(tmp_path / "torch_ks10k_dissipation", _mbpo(-480.0, best=-235.0)[:1])
    _write_stream(tmp_path / "ks50k_dissipation", _mbpo(-479.0, best=-207.0))
    _write_stream(tmp_path / "torch_ks10k_bf16", _mbpo(-250.0, best=-190.0) + [(49_990, -215.0)])
    _write_stream(tmp_path / "ks50k_bf16", _mbpo(-249.0, best=-166.0))
    sac = [(6000, -560.0), (45000, -350.0), (105000, -200.0), (235000, -150.0),
           (495000, -118.0)]
    for name in ("torch_sac500k", "torch_sac500k_dissipation", "sac500k_dissipation"):
        _write_stream(tmp_path / name, sac)
    _write_stream(tmp_path / "sac500k", sac[:3])
    _write_stream(tmp_path / "jax_cpu_sac", sac[:2])
    monkeypatch.setattr(long_run, "PORT_SAC", {"l2control": ("torch_sac500k",),
                                               "dissipation": ("torch_sac500k_dissipation",)})
    monkeypatch.setattr(long_run, "JAX_CPU_SAC", {"l2control": ("jax_cpu_sac",),
                                                  "dissipation": ()})
    # A channel without a port MBPO run holds its SAC streams to JAX's best.
    monkeypatch.setattr(long_run, "PORT_MBPO", {**long_run.PORT_MBPO, "dissipation": ()})
    out = long_run.compare(str(tmp_path))
    l2 = out["channels"]["l2control"]
    assert l2["port"]["target"] == pytest.approx(np.median([-171.0, -177.0, -177.0, -177.0]))
    assert l2["port"]["sac"]["torch_sac500k"]["first_reach"] == 235000
    assert l2["jax"]["target"] == -154.0
    assert l2["jax"]["sac"]["sac500k"]["first_reach"] is None  # never reaches -154
    assert l2["jax"]["sac"]["sac500k"]["eval_at_50k"] == -350.0
    assert l2["jax"]["mbpo"]["ks50k"]["eval_at"][50000] == -186.0
    assert l2["port"]["targets_of"] == "own"
    cpu = l2["jax_cpu"]["sac"]["jax_cpu_sac"]
    assert cpu["evals_to_50k"] == [[6000, -560.0], [45000, -350.0]]
    assert cpu["first_reach"] is None and l2["jax_cpu"]["target"] == -154.0
    # No port MBPO run on the dissipation channel: JAX's best is the target.
    diss = out["channels"]["dissipation"]
    assert diss["port"]["mbpo"] == {} and diss["port"]["targets_of"] == "jax"
    assert diss["port"]["target"] == diss["jax"]["target"] == -207.0
    assert diss["port"]["sac"]["torch_sac500k_dissipation"]["ratio"] == 105000 / 50000
    pairs = out["pairs"]
    assert pairs["torch_ks10k_bf16"]["outside"]  # reached 50k, under -181
    assert pairs["torch_ks10k_bf16"]["jax"]["best"] == -166.0
    assert pairs["torch_ks10k_dissipation"]["port"]["env_steps"] == 9_500
    assert pairs["torch_ks10k_dissipation"]["outside"] is None  # stopped at 9,500
    lag = out["lag_test"]
    assert list(lag["jax"]) == ["ks50k", "ks50k_seed1"]
    assert "ks50k_dissipation" in lag["jax_left_out"]
    assert lag["port"]["torch_ks50k_seed2"] == pytest.approx(-262.0)
    assert (lag["p"], lag["splits"], lag["verdict"]) == (pytest.approx(1 / 15), 15, "open")


@pytest.mark.parametrize("inside", [True, False], ids=["inside", "outside"])
@pytest.mark.parametrize("port", ["torch_ks50k_dissipation", "torch_ks50k_latent_r4",
                                  "torch_burgers20k"])
def test_a_full_length_pair_is_held_to_its_limit(tmp_path, port, inside):
    """A run of the dissipation, latent or Burgers runscript to its full
    length (Burgers' 20,000 env steps, evaluated every 500) beside its JAX
    run at its marks (every 5,000 for Burgers, 10,000 for the others): its
    best inside its limit holds the path, outside it does not; the same run
    cut short is not asked."""
    pair = long_run.PAIRS[port]
    marks = list(range(pair.every, pair.steps + 1, pair.every))
    best = pair.limit * (0.99 if inside else 1.01)  # the limits are negative
    evals = [(m - 500, best * 2) for m in marks] + [(pair.steps - 10, best)]
    _write_stream(tmp_path / port, sorted(evals))
    _write_stream(tmp_path / pair.jax, [(m - 500, pair.limit * 0.9) for m in marks])
    out = long_run._pair(str(tmp_path), port, pair)
    assert out["outside"] is (not inside)
    assert (out["limit"], out["full_length"], out["port"]["best"]) == (pair.limit, pair.steps, best)
    assert list(out["port"]["eval_at"]) == list(out["jax"]["eval_at"]) == marks
    assert out["port"]["env_steps"] == pair.steps - 10
    cut = tmp_path / "cut"
    _write_stream(cut / port, sorted(evals)[:2])
    _write_stream(cut / pair.jax, [(m - 500, pair.limit * 0.9) for m in marks])
    assert long_run._pair(str(cut), port, pair)["outside"] is None
