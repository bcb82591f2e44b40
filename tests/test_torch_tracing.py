"""The loop's tracing on the CPU (``utils/profiling.py``): host spans nest
and name their parents, enter ``record_function`` only under an active
profiler, and add-form stamps sum their pairs; a fused ``learn()`` logs
each phase's stamped time, within the host's time of the iteration; the
lock-step fit counts the member-steps it computed and those of stopped
members, as a hand count from the members' own steps gives them."""

import json
import time

import numpy as np
import pytest
import torch

from pdecontrol_tpu_torch.mbrl import controller as CT
from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.models.surrogate import stack_parameters
from pdecontrol_tpu_torch.train import trainer as TTrn
from pdecontrol_tpu_torch.train.losses import make_loss
from pdecontrol_tpu_torch.train.schedulers import ConstantLengthScheduler
from pdecontrol_tpu_torch.utils import profiling

from .test_torch_fused import ARGS
from .test_torch_lockstep_fit import (CASES, FILL, K, M, TRAIN, _members, _replay, _table,
                                      _transforms)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spans_nest_and_name_their_parents():
    tracer = profiling.Tracer()
    with tracer.span("iteration") as outer:
        with tracer.span("iteration.dispatch") as inner:
            pass
        with tracer.span("iteration.pull") as pull:
            pull.fields = {"n": 1}
    with tracer.span("retrain"):
        pass
    names = [(s[0], s[3]) for s in tracer.spans]
    # A span enters the ring when it closes, so a parent after its children.
    assert names == [("iteration.dispatch", "iteration"), ("iteration.pull", "iteration"),
                     ("iteration", None), ("retrain", None)]
    assert tracer.spans[1][4] == {"n": 1} and tracer.spans[0][4] is None
    assert outer.start <= inner.start <= inner.end <= pull.start <= pull.end <= outer.end
    assert outer.seconds == (outer.end - outer.start) * 1e-9 >= inner.seconds + pull.seconds
    assert tracer.offset_ns == 0  # on the CPU a stamp is the spans' own clock


def test_ring_keeps_the_last_spans():
    tracer = profiling.Tracer(capacity=3)
    for i in range(5):
        with tracer.span(f"s{i}"):
            pass
    assert [s[0] for s in tracer.spans] == ["s2", "s3", "s4"]


def test_span_enters_record_function_only_under_a_profiler(monkeypatch, tmp_path):
    """Under a profiler a span is a record on the trace's host rows, as an
    operator is, not a user annotation (which the profiler mirrors onto the
    device rows); with none it enters nothing."""
    entered = []
    real = profiling.RecordFunction

    def recording(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "RecordFunction", recording)
    tracer = profiling.Tracer()
    with tracer.span("untraced"):
        pass
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("traced.outer"):
            with tracer.span("traced.inner"):
                torch.ones(4).sum()
    assert entered == ["traced.outer", "traced.inner"]
    names = {e.key for e in prof.key_averages()}
    assert {"traced.outer", "traced.inner"} <= names
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    cats = {e.get("cat") for e in events if e.get("name", "").startswith("traced.")}
    assert cats == {"cpu_op"}
    with tracer.span("after"):
        pass
    assert entered == ["traced.outer", "traced.inner"]


def test_add_form_stamps_sum_their_pairs():
    """Three SUB/ADD pairs around sleeps leave the sum of the three
    durations, bracketed by host reads inside and outside each pair; a SET
    stamp writes the clock."""
    slots = torch.zeros((2,), dtype=torch.int64)
    inner = outer = 0
    for _ in range(3):
        o0 = time.perf_counter_ns()
        profiling.stamp(slots, 0, profiling.SUB)
        i0 = time.perf_counter_ns()
        time.sleep(0.002)
        i1 = time.perf_counter_ns()
        profiling.stamp(slots, 0, profiling.ADD)
        o1 = time.perf_counter_ns()
        inner += i1 - i0
        outer += o1 - o0
    assert inner <= int(slots[0]) <= outer
    assert int(slots[0]) >= 3 * 2_000_000
    h0 = time.perf_counter_ns()
    profiling.stamp(slots, 1)
    assert h0 <= int(slots[1]) <= time.perf_counter_ns()


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    """A tiny ``learn()`` on the fused route (``tests/test_torch_fused.py``'s
    arguments: retrains at 0 and 4, evaluations at 0, 3 and 6)."""
    run_dir = tmp_path_factory.mktemp("tracing") / "run"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = script.build_parser().parse_args(ARGS + ["--run_dir", str(run_dir)])
        ctl = CT.PDEModelBasedController(script.config_from_args(args), device="cpu")
        ctl.learn()
        ctl.logger.finish()
    finally:
        torch.set_num_threads(n)
    with open(run_dir / "metrics.jsonl") as f:
        return ctl, [json.loads(line) for line in f]


def test_fused_records_carry_stamped_phase_times(fused_run):
    """Every fused record's phases are stamped, at least 0 s each; on the
    CPU the body runs inside the dispatch, so the phases sum to at most
    ``t_dispatch``, and with the wait since the previous replay to at most
    the host's time from that replay's dispatch to this one's end."""
    ctl, records = fused_run
    fused = [r for r in records if "t_dispatch" in r]
    assert [r["iteration"] for r in fused] == [1, 2, 3, 5, 6, 7]
    dispatches = [(s[1], s[2]) for s in ctl.tracer.spans if s[0] == "iteration.dispatch"]
    assert len(dispatches) == len(fused)
    phases = ["t_dev_collect", "t_dev_imagine", "t_dev_policy"]
    rounding = 5e-5 + 3 * 5e-7  # t_dispatch to 4 decimals, the stamps to 6
    for j, r in enumerate(fused):
        assert all(r[k] >= 0 for k in phases), r
        assert sum(r[k] for k in phases) <= r["t_dispatch"] + rounding, r
        if "t_dev_wait" in r:
            assert r["t_dev_wait"] >= 0
            host = (dispatches[j][1] - dispatches[j - 1][0]) * 1e-9
            assert sum(r[k] for k in phases) + r["t_dev_wait"] <= host + 4 * 5e-7, r
    # The wait is left out after a retrain and after an evaluation.
    assert [r["iteration"] for r in fused if "t_dev_wait" in r] == [2, 3, 6]


def test_spans_of_the_loop_derive_its_timers(fused_run):
    """``t_dispatch`` is its span's length; every iteration and retrain
    has its span, and the fit's epochs theirs under it."""
    ctl, records = fused_run
    spans = list(ctl.tracer.spans)
    names = [s[0] for s in spans]
    assert names.count("iteration") == len(records)
    assert names.count("retrain") == 2
    dispatch = [s for s in spans if s[0] == "iteration.dispatch"]
    fused = [r for r in records if "t_dispatch" in r]
    for s, r in zip(dispatch, fused):
        assert s[3] == "iteration"
        assert r["t_dispatch"] == round((s[2] - s[1]) * 1e-9, 4)
    parents = {s[0]: s[3] for s in spans}
    assert parents["fit.prep"] == parents["fit.epoch"] == "retrain"
    assert parents["fit.dispatch"] == parents["fit.pull"] == "fit.epoch"
    retrains = [s[4] for s in spans if s[0] == "retrain"]
    logged = [r for r in records if "t_fit_dispatch" in r]
    assert [f["t_fit_dispatch"] for f in retrains] == [r["t_fit_dispatch"] for r in logged]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_counts_masked_member_steps(case):
    """The lock-step fit of ``tests/test_torch_lockstep_fit.py`` on its table
    of batches: under patience its members stop at different epochs.  Every
    step computes all M members, so the fit computed M x its steps, and
    of them were masked all but the members' own steps (their
    ``global_step``)."""
    cfg = TTrn.TrainConfig(**CASES[case])
    und, stransf = _transforms()
    train, val = _table(2, 36), _table(3, 12)
    trainer = TTrn.SurrogateTrainer(make_loss("MSELoss", {}), cfg)
    drawn = {"train": 0, "val": 0}

    def draw_members(replay, generator, m, length, mask, stransf_):
        kind = "val" if mask is trainer._inputs.val_mask else "train"
        drawn[kind] += 1
        return (train if kind == "train" else val)[drawn[kind] - 1]

    trainer._draw_members = draw_members
    modules = _members()
    state = trainer.init_members(modules, stack_parameters(modules))
    state, _, logs = trainer.fit_ensemble(
        state, _replay(), torch.as_tensor(TRAIN), torch.as_tensor(~TRAIN & (FILL > 0)),
        und, stransf, ConstantLengthScheduler(length=K), 0, None)
    own = state.global_step.tolist()
    assert logs["fit_member_steps"] == M * logs["steps"] == M * max(own)
    assert logs["fit_masked_member_steps"] == M * max(own) - sum(own)
    if case == "patience":
        assert len(set(own)) > 1 and logs["fit_masked_member_steps"] > 0, own
    else:
        assert logs["fit_masked_member_steps"] == 0
    # The stamps: each part at least 0.
    assert logs["t_fit_dev_wait"] >= 0
    assert logs["t_fit_dev_step"] > 0 and logs["t_fit_dev_val"] > 0
    assert np.isfinite([logs[k] for k in logs if k.startswith("t_fit_dev")]).all()
