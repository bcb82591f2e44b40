"""The port's fused MBPO iteration on the CPU (``mbrl/controller.py``): the
counterpart of the JAX package's ``test_fused_iteration_matches_unfused``
(``tests/test_mbrl_smoke.py``), the fields of the fused metrics stream
(``pdecontrol_tpu/mbrl/controller.py:1373-1381``, ``:1389`` and
``:1465-1484``), its one-iteration-late commit, and the helpers of
``utils/graphs.py`` that run without a card.  On the CPU the fused body runs
eagerly; the CUDA graph of it is held to the eager body in
``tests/test_torch_cuda.py``."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
from pdecontrol_tpu_torch.ops import pallas_ks
from pdecontrol_tpu_torch.utils import graphs

from .test_torch_slice import SMOKE_ARGS

# 8 iterations of 2 samples: retrains at 0 and 4, evaluations at 0, 3 and 6,
# so 3 and 6 are fused evaluation iterations and 1, 2, 5 and 7 are pulled
# one iteration late.
ARGS = SMOKE_ARGS + ["--logging_freq", "0", "--agent_eval_freq", "3"]
ITERATIONS = 8
# Fields of a record that read the host's clock or its garbage collector.
WALL_CLOCK = ("start", "time", "_time", "env_steps_per_sec", "gc_max_pause", "n_gc2")
LOGGER = {"_step", "_time"}
# pdecontrol_tpu/mbrl/controller.py:1373-1381 with _commit_record's fields
# and t_ready (:1298-1326): a non-evaluation fused iteration.
JAX_PIPELINED = {
    "iteration", "num_steps_sampled", "horizon", "num_pol_updates", "t_dispatch", "time",
    "world_buffer_samples", "collect_reward_mean", "imagined_reward_mean", "sac_qf_loss",
    "sac_policy_loss", "env_steps_per_sec", "t_ready",
}
# :1389 and :1465-1484: a fused evaluation iteration, with the evaluations'
# fields (:1447-1463).
JAX_FUSED_EVAL = (JAX_PIPELINED - {"t_ready"}) | {
    "t_fused", "t_eval", "eval_return_mean", "eval_return_std", "surrogate_open_loop_mse",
    "reward_model_error", "world_return_mean", "world_return_std",
}
# The port's device stamps: each phase's device time in every fused record,
# and the card's wait for the host since the previous replay in one that
# follows a fused, non-evaluation iteration.
PORT_STAMPS = {"t_dev_collect", "t_dev_imagine", "t_dev_policy"}
# The port's count of the world step's auto-resets, drawn and run, in every
# record.
PORT_RESETS = {"world_resets_drawn", "world_resets_run"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _controller(run_dir, *flags):
    args = script.build_parser().parse_args(ARGS + ["--run_dir", str(run_dir)] + list(flags))
    return PDEModelBasedController(script.config_from_args(args), device="cpu")


def _records(run_dir):
    return [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same tiny run with the fused iteration and with the eager phases;
    for the fused one, the iterations committed when each iteration ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, flags in (("fused", ()), ("eager", ("--no_fuse_iteration",))):
            run_dir = tmp_path_factory.mktemp(name)
            ctl = _controller(run_dir, *flags)
            committed, seen = [], []
            log, run = ctl.logger.log, ctl._run_iteration

            def logged(record, commit=True, log=log, committed=committed):
                if commit:
                    committed.append(record.get("iteration"))
                log(record, commit=commit)

            def iteration(run=run, committed=committed, seen=seen, ctl=ctl):
                run()
                seen.append((ctl.iteration - 1, list(committed)))

            ctl.logger.log, ctl._run_iteration = logged, iteration
            try:
                ctl.learn()
            finally:
                ctl.logger.finish()
            out[name] = (ctl, _records(run_dir), seen)
    finally:
        torch.set_num_threads(n)
    return out


def test_fused_iteration_matches_unfused(runs):
    """Replay, world replay, SAC parameters and Adam moments, the transforms,
    the generator and every non-clock field of every record: identical."""
    fused, eager = runs["fused"][0], runs["eager"][0]
    assert fused.fused and not eager.fused
    assert fused.iteration == eager.iteration == ITERATIONS
    for name in ("replay", "world_replay"):
        for f in dataclasses.fields(fused.replay):
            np.testing.assert_array_equal(getattr(getattr(fused, name), f.name).numpy(),
                                          getattr(getattr(eager, name), f.name).numpy())
    for net in ("policy", "critic", "target"):
        a = getattr(fused.sac_state, net).state_dict()
        b = getattr(eager.sac_state, net).state_dict()
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    for opt in ("policy_opt", "critic_opt", "alpha_opt"):
        a = getattr(fused.sac_state, opt).state_dict()["state"]
        b = getattr(eager.sac_state, opt).state_dict()["state"]
        assert a.keys() == b.keys() and (a or opt == "alpha_opt")  # alpha is fixed
        for k in a:
            for m in ("exp_avg", "exp_avg_sq", "step"):
                np.testing.assert_array_equal(a[k][m].numpy(), b[k][m].numpy())
    for t_fused, t_eager in zip(graphs.tensors_of(fused.tr, fused.env_state),
                                graphs.tensors_of(eager.tr, eager.env_state)):
        np.testing.assert_array_equal(t_fused.numpy(), t_eager.numpy())
    np.testing.assert_array_equal(fused.gen.get_state().numpy(), eager.gen.get_state().numpy())
    assert (fused.num_pol_updates, fused.sac_state.updates) == \
        (eager.num_pol_updates, eager.sac_state.updates)

    def strip(record):
        return {k: v for k, v in record.items()
                if k not in WALL_CLOCK and not k.startswith("t_")}

    a, b = runs["fused"][1], runs["eager"][1]
    assert [strip(r) for r in a] == [strip(r) for r in b]


def test_fused_records_carry_the_jax_fields(runs):
    ctl, records, _ = runs["fused"]
    assert [r["iteration"] for r in records] == list(range(ITERATIONS))
    assert ctl._pending_log is None  # nothing stays pending after learn()
    for r in records:
        i = r["iteration"]
        if i % 4 == 0:  # a retrain runs its phases eagerly, as in JAX
            assert {"t_collect", "t_surrogate", "t_imagine", "t_policy", "t_pull"} \
                | PORT_RESETS <= set(r)
            assert not ({"t_dispatch", "t_ready", "t_fused", "t_dev_wait"} | PORT_STAMPS) & set(r)
            continue
        wait = {"t_dev_wait"} if (i - 1) % 4 and (i - 1) % 3 else set()
        if i % 3 == 0:
            assert set(r) == JAX_FUSED_EVAL | LOGGER | PORT_STAMPS | PORT_RESETS | wait, i
        else:
            assert set(r) == JAX_PIPELINED | LOGGER | PORT_STAMPS | PORT_RESETS | wait, i


def test_records_are_committed_one_iteration_late(runs):
    """A pipelined iteration leaves its own record pending and commits the
    previous one; an evaluation or retrain iteration commits both."""
    _, _, seen = runs["fused"]
    for i, committed in seen:
        late = i % 4 != 0 and i % 3 != 0
        assert committed == list(range(i if late else i + 1)), (i, committed)
    _, _, seen = runs["eager"]
    assert all(committed == list(range(i + 1)) for i, committed in seen)


def test_debug_nans_selects_the_eager_phases(tmp_path, capsys):
    args = script.build_parser().parse_args(ARGS + ["--run_dir", str(tmp_path)])
    ctl = PDEModelBasedController(script.config_from_args(args), device="cpu",
                                  debug_nans=True)
    ctl.logger.finish()
    assert ctl.config.fuse_iteration and not ctl.fused
    assert "--debug_nans runs the eager phases" in capsys.readouterr().out


def test_fused_route_refuses_a_partial_target_update_pattern(tmp_path):
    """A graph holds the target-update pattern of the updates it captured,
    so their count must be a multiple of the interval."""
    with pytest.raises(ValueError, match="--no_fuse_iteration"):
        _controller(tmp_path, "--target_update_interval", "3")
    _controller(tmp_path / "eager", "--target_update_interval", "3",
                "--no_fuse_iteration").logger.finish()
    _controller(tmp_path / "two", "--target_update_interval", "2").logger.finish()


# ------------------------------------------------------------ utils/graphs
@dataclasses.dataclass
class _State:
    a: torch.Tensor
    pair: tuple
    flag: bool = True


def test_copy_into_writes_in_place():
    dst = _State(torch.zeros(3), (torch.zeros(2), torch.zeros((), dtype=torch.int64)))
    ptrs = [t.data_ptr() for t in graphs.tensors_of(dst)]
    graphs.copy_into(dst, _State(torch.arange(3.0), (torch.ones(2), torch.tensor(7))))
    assert [t.data_ptr() for t in graphs.tensors_of(dst)] == ptrs
    assert dst.a.tolist() == [0.0, 1.0, 2.0] and dst.pair[1].item() == 7
    with pytest.raises(ValueError):
        graphs.copy_into(dst, _State(torch.zeros(3), (torch.zeros(2),)))
    with pytest.raises(ValueError):
        graphs.copy_into(dst, _State(torch.zeros(3), dst.pair, flag=False))


def test_tensors_of_walks_modules_optimizers_and_dataclasses():
    net = torch.nn.Linear(2, 3)
    opt = torch.optim.Adam(net.parameters())
    net(torch.ones(1, 2)).sum().backward()
    opt.step()
    state = _State(torch.zeros(1), ({"x": torch.ones(2)}, [net]))
    got = graphs.tensors_of(state, opt)
    moments = [t for s in opt.state.values() for t in s.values()]
    assert len(got) == 1 + 1 + 2 + len(moments) == 10
    assert got[0] is state.a and got[2] is net.weight and got[-1] is moments[-1]


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_captured_graph_replay_counts_launches_and_checks_addresses(monkeypatch):
    monkeypatch.setattr(pallas_ks, "launch_count", 5)
    state = [torch.zeros(4), torch.ones(2)]
    captured = graphs.CapturedGraph(
        graph=_Graph(), output=torch.zeros(6), launches={pallas_ks: 3},
        addresses=[t.data_ptr() for t in state], seconds=0.0, pool_bytes=0)
    assert captured.replay(state) is captured.output
    captured.replay(state)
    assert pallas_ks.launch_count == 11 and captured.graph.replays == 2
    state[1] = state[1].clone()  # rebound, not written in place
    with pytest.raises(RuntimeError, match="in place"):
        captured.replay(state)
    assert captured.graph.replays == 2


def test_graph_cache_run_warms_up_captures_then_replays_a_copy():
    """``GraphCache.run`` without a card, its capture stood in for: the
    first call runs the body eagerly and then captures it; the host counter
    the capture advanced is put back and advanced by each replay; a replay
    returns a copy of the graph's output; a failed capture raises with the
    key, the counter put back."""
    class Counter:
        updates = 0

    counter, state = Counter(), [torch.zeros(3)]

    def body():
        counter.updates += 2
        state[0].add_(1)
        return {"x": state[0] * 1}

    cache = graphs.GraphCache([])

    def capture(key, body_, state_):
        out = body_()  # the capture runs the body's host code once
        cache.graphs[key] = graphs.CapturedGraph(
            graph=_Graph(), output=out, launches={}, addresses=[t.data_ptr() for t in state_],
            seconds=0.0, pool_bytes=0)
        return cache.graphs[key]

    cache.capture = capture
    seen = []
    first = cache.run("k", body, lambda: state, "the test body", ((counter, "updates"),), seen)
    assert float(first["x"][0]) == 1 and counter.updates == 2 and len(seen) == 1
    again = cache.run("k", body, lambda: state, "the test body", ((counter, "updates"),), seen)
    assert counter.updates == 4 and len(seen) == 1 and seen[0].graph.replays == 1
    assert torch.equal(again["x"], seen[0].output["x"])
    assert again["x"].data_ptr() != seen[0].output["x"].data_ptr()

    def failing(key, body_, state_):
        body_()
        raise RuntimeError("operation not permitted when stream is capturing")

    cache.capture = failing
    with pytest.raises(RuntimeError, match="capturing the test body j as a CUDA graph failed"):
        cache.run("j", body, lambda: state, "the test body", ((counter, "updates"),))
    assert counter.updates == 6 and "j" not in cache.graphs


def test_world_step_picks_the_reset_on_the_device(runs):
    """The world step's auto-reset without a host read: where every sub-env
    is at its time limit the step returns the fresh state drawn after the
    advance, else the advanced one; ``reset=False`` draws nothing."""
    ctl = runs["fused"][0]
    world, ens, tr, gen = ctl.world, ctl.ensemble, ctl.tr, ctl.gen
    saved = gen.get_state()
    try:
        state = world.reset(gen, ens, ctl.replay, tr)
        action = torch.zeros((world.num_envs,) + tuple(ctl.env.action_shape))
        waction = tr.env_action_to_world(tr.agent_to_env_action(action))
        for start, done in ((world.max_episode_steps - 1, True), (0, False)):
            before = dataclasses.replace(
                state, timesteps=torch.full_like(state.timesteps, start))
            drawn = gen.get_state()
            got, (obs, _, term, trunc, final) = world.step(
                gen, before, ens, action, tr, 5, ctl.replay)
            assert trunc.tolist() == [done] * world.num_envs and not term.any()
            gen.set_state(drawn)
            stepped, _ = world.advance(gen, before, ens, waction, tr)
            fresh = world.reset(gen, ens, ctl.replay, tr)
            want = fresh if done else stepped
            for a, b in zip(graphs.tensors_of(got), graphs.tensors_of(want)):
                assert torch.equal(a, b)
            assert torch.equal(obs, want.obs) and torch.equal(final, stepped.obs)
            assert int(got.simulated) == (0 if done else 1)

            gen.set_state(drawn)
            got, _ = world.step(gen, before, ens, action, tr, 5, ctl.replay, reset=False)
            for a, b in zip(graphs.tensors_of(got), graphs.tensors_of(stepped)):
                assert torch.equal(a, b)
    finally:
        gen.set_state(saved)


def test_world_resets_run_counts_the_done_steps(runs):
    """``world_resets_run`` gains one at a world step where the whole batch
    is done (every warmup window ends one step short of the time limit, so
    each step reaches it) and nothing where the batch goes on (every window
    at step 0); every record counts ``rounds * (horizon - 1)`` resets drawn
    and no more run."""
    ctl = runs["fused"][0]
    horizon = 3
    state = graphs.tensors_of(ctl.replay, ctl.world_replay)
    saved, gen = [t.clone() for t in state], ctl.gen.get_state()
    try:
        for start, done in ((ctl.world.max_episode_steps - 1, True), (0, False)):
            ctl.replay.steps.fill_(start)
            _, _, ran = ctl._imagine_body(horizon)
            assert ran.dtype == torch.int64
            assert int(ran) == (ctl.world_rounds * (horizon - 1) if done else 0), start
    finally:
        graphs.copy_into(state, saved)
        ctl.gen.set_state(gen)
    for r in runs["fused"][1] + runs["eager"][1]:
        assert r["world_resets_drawn"] == ctl.world_rounds * (r["horizon"] - 1), r
        assert 0 <= r["world_resets_run"] <= r["world_resets_drawn"], r


def test_waterfall_sums_the_fused_fields(runs, tmp_path):
    from pdecontrol_tpu_torch.utils import waterfall

    for name, fields in (("fused", {"t_dispatch", "t_ready", "t_fused"}), ("eager", set())):
        path = tmp_path / f"{name}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in runs[name][1]))
        out = waterfall.analyze(str(path))
        assert set(out["fused_s"]) <= fields and (not fields or out["fused_s"])
        assert out["retrain"]["n"] == 2 and out["eval"]["n"] + out["steady"]["n"] == 6
