"""The ``program_span`` readers of the program's own tracing, on made-up
contexts: the h7 readers take medians of the window records' stamped
times, the fit readers find the window's retrains among the controller's
``retrain`` spans, and all of them read nothing from a program without
that tracing (the parent of the change that added it)."""

import types

import pytest

from benchmarks.harness import spans
from benchmarks.harness.cell import ROOT, load_module


def reader(name):
    return load_module(ROOT / "benchmarks" / "metrics" / f"{name}.py").read


H7 = {"collect_dev_ms.h7": "t_dev_collect", "world_dev_ms.h7": "t_dev_imagine",
      "policy_dev_ms.h7": "t_dev_policy", "replay_wait_ms.h7": "t_dev_wait"}


@pytest.mark.parametrize("name", sorted(H7))
def test_h7_readers_take_the_median_of_the_window(name):
    field = H7[name]
    window = [{field: 0.3}, {field: 0.1}, {"t_dispatch": 0.4}, {field: 0.2}]
    assert reader(name)({"window": window}) == pytest.approx(200.0)
    # The parent's records carry no stamps.
    assert reader(name)({"window": [{"t_dispatch": 0.4}]}) is None
    assert reader(name)({"window": []}) is None


def fit_logs(steps, dispatch, total, dev_step, dev_wait, members, masked, epochs=3):
    return {"steps": steps, "epochs": epochs, "t_fit_dispatch": dispatch,
            "t_fit_total": total, "t_fit_dev_step": dev_step, "t_fit_dev_wait": dev_wait,
            "fit_member_steps": members, "fit_masked_member_steps": masked}


def context(logs, window):
    """A traced retrain cell's context: the controller's ring holds the
    set-up's, the window's and the traced retrain's spans, with the fit
    spans between them; the window records keep four fields of each."""
    ring = []
    for f in logs:
        ring.append(("fit.epoch", 0, 1, "retrain", None))
        ring.append(("retrain", 0, 2, None, f))
    keep = ("steps", "epochs", "t_fit_dispatch", "t_fit_total")
    ctl = types.SimpleNamespace(tracer=types.SimpleNamespace(spans=ring))
    return {"ctl": ctl, "window": [{k: f[k] for k in keep} for f in window]}


SETUP = [fit_logs(1, 0.001, 0.5, 0.02, 0.001, 3, 0), fit_logs(19, 0.02, 0.6, 0.5, 0.04, 57, 0)]
WINDOW = [fit_logs(250, 0.25, 7.4, 6.5, 0.5, 750, 150), fit_logs(200, 0.2, 6.0, 5.5, 0.3, 600, 0)]
TRACED = [fit_logs(38, 0.04, 1.2, 1.0, 0.1, 114, 0)]


def test_fit_readers_read_the_window_retrains_alone():
    ctx = context(SETUP + WINDOW + TRACED, WINDOW)
    assert spans.window_fits(ctx) == WINDOW
    assert reader("fit_step_dev_ms.fit")(ctx) == pytest.approx(1e3 * 12.0 / 450)
    assert reader("fit_wait_ms.fit")(ctx) == pytest.approx(1e3 * 0.8 / 450)
    assert reader("fit_active_pct.fit")(ctx) == pytest.approx(100.0 * 1200 / 1350)


def test_fit_readers_take_the_last_match():
    """A set-up retrain with the same four fields as the window's comes
    before it: the window's are the last such run."""
    early = dict(WINDOW[0], t_fit_dev_step=99.0)
    ctx = context([early] + WINDOW + TRACED, WINDOW)
    assert spans.window_fits(ctx) == WINDOW


def test_fit_readers_read_nothing_without_the_programs_tracing():
    ctx = context(SETUP + WINDOW + TRACED, WINDOW)
    parent = dict(ctx, ctl=types.SimpleNamespace())  # a controller without a tracer
    unmatched = context(SETUP + TRACED, WINDOW)
    no_stamps = context([{k: v for k, v in f.items() if not k.startswith(("t_fit_dev", "fit_"))}
                         for f in WINDOW], WINDOW)
    for name in ("fit_step_dev_ms.fit", "fit_wait_ms.fit", "fit_active_pct.fit"):
        for c in (parent, unmatched, no_stamps, dict(ctx, window=[])):
            assert reader(name)(c) is None, name
