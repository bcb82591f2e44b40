"""Checkpoint and resume of the port (``pdecontrol_tpu_torch/utils/checkpoint.py``
and the controller's resume rule): ports of the JAX package's
``tests/test_checkpoint_viz.py`` checkpoint tests, the manager's contract
(atomic publication, ``max_to_keep``, loud failures, snapshots detached from
the live tensors), and the exact continuation of a resumed run."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
from pdecontrol_tpu_torch.utils import checkpoint as C
from pdecontrol_tpu_torch.utils.checkpoint import CheckpointManager
from pdecontrol_tpu_torch.utils.logging import MetricsLogger

from .test_torch_slice import SMOKE_ARGS

# The smoke sizes with buffers as small as the run: a snapshot holds both
# replays whole.
SMALL = SMOKE_ARGS + ["--capacity", "256", "--model_buffer_max_capacity", "64",
                      "--model_buffer_store_iterations", "2"]
# Fields of a metrics record that depend on the host's clock or its garbage
# collector, not on the training state.
WALL_CLOCK = ("start", "time", "_time", "env_steps_per_sec", "gc_max_pause", "n_gc2")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _controller(run_dir, *flags):
    args = script.build_parser().parse_args(SMALL + ["--run_dir", str(run_dir)] + list(flags))
    ctl = PDEModelBasedController(script.config_from_args(args), device="cpu")
    return ctl


def _learn(run_dir, *flags):
    ctl = _controller(run_dir, *flags)
    try:
        ctl.learn()
    finally:
        ctl.logger.finish()
    return ctl


def _records(run_dir):
    return [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]


def _assert_same(a, b, path="state"):
    """Exact equality of two snapshots: every tensor, number and key."""
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict)), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), f"{path}: max abs diff " \
            f"{(a.double() - b.double()).abs().max().item()}"
    else:
        assert a == b, path


# ------------------------------------------------------------- the manager
def test_checkpoint_failure_is_not_silent(tmp_path):
    """A failed background save raises again at the next save()/wait(), and
    the manager stays usable."""
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(0, {"bad": lambda: None})  # not serialisable: the worker fails
    with pytest.raises(Exception):
        ckpt.wait()
    ckpt.save(1, {"bad": lambda: None})
    ckpt._pending[0].exception()  # let the worker finish
    with pytest.raises(Exception):
        ckpt.save(2, {"x": torch.arange(4)})
    assert ckpt.latest_step() is None
    ckpt.save(3, {"x": torch.arange(4)}, wait=True)
    assert ckpt.latest_step() == 3
    out = ckpt.restore({"x": torch.zeros(4, dtype=torch.int64)})
    assert torch.equal(out["x"], torch.arange(4))


@pytest.mark.parametrize("crash_in", ["save", "replace"])
def test_crash_mid_write_leaves_no_restorable_step(tmp_path, monkeypatch, crash_in):
    """A write that dies half way, or before the rename, leaves only the
    temporary file: no step that restore() would accept."""
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    if crash_in == "save":
        def dying_save(obj, path):
            with open(path, "wb") as f:
                f.write(b"half a file")
            raise OSError("killed mid-write")

        monkeypatch.setattr(torch, "save", dying_save)
    else:
        def dying_replace(src, dst):
            raise OSError("killed before the rename")

        monkeypatch.setattr(os, "replace", dying_replace)
    ckpt.save(5, {"x": torch.ones(3)})
    with pytest.raises(OSError, match="killed"):
        ckpt.wait()
    monkeypatch.undo()
    assert os.listdir(ckpt.directory) == [".tmp-5.pt"]
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    # A new manager on the same directory (the restarted process) sees none.
    assert CheckpointManager(ckpt.directory).latest_step() is None


def test_max_to_keep_and_latest_step(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    for step in (2, 4, 6, 8, 10):
        ckpt.save(step, {"step": step, "x": torch.full((2,), float(step))})
    ckpt.wait()
    assert sorted(os.listdir(ckpt.directory)) == ["10.pt", "6.pt", "8.pt"]
    assert ckpt.latest_step() == 10
    assert ckpt.restore()["step"] == 10
    assert torch.equal(ckpt.restore(step=6)["x"], torch.full((2,), 6.0))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(step=2)
    assert CheckpointManager(ckpt.directory, max_to_keep=1).latest_step() == 10


def test_snapshot_is_unaffected_by_later_in_place_writes(tmp_path, monkeypatch):
    """save() copies the state before it returns: writes made while the
    worker has not yet written the file do not reach the snapshot."""
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    gate = threading.Event()
    write = ckpt._write

    def held_write(step, host_state):
        assert gate.wait(timeout=30)
        write(step, host_state)

    monkeypatch.setattr(ckpt, "_write", held_write)
    state = {"replay": {"obs_seq": torch.zeros(4, 3)}, "opt": [{"m": torch.ones(2)}],
             "count": 7}
    ckpt.save(1, state)
    state["replay"]["obs_seq"][2] = 5.0  # the replay is written in place
    state["opt"][0]["m"].mul_(3.0)
    gate.set()
    out = ckpt.restore()
    assert torch.equal(out["replay"]["obs_seq"], torch.zeros(4, 3))
    assert torch.equal(out["opt"][0]["m"], torch.ones(2))
    assert out["count"] == 7


@pytest.mark.parametrize("saved, match", [
    ({"a": torch.zeros(3), "b": {"c": torch.zeros(2, 2)}}, None),
    ({"a": torch.zeros(4), "b": {"c": torch.zeros(2, 2)}}, r"state\['a'\] is \(4,\)"),
    ({"a": torch.zeros(3), "b": {"c": torch.zeros(2, 2, dtype=torch.float64)}},
     r"state\['b'\]\['c'\]"),
    ({"a": torch.zeros(3), "b": {"d": torch.zeros(2, 2)}}, r"state\['b'\] has other keys"),
    ({"a": torch.zeros(3)}, r"other keys \('b'\)"),
    ({"a": 1.0, "b": {"c": torch.zeros(2, 2)}}, r"state\['a'\] is not a tensor"),
])
def test_restore_holds_the_snapshot_to_its_target(tmp_path, saved, match):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(0, saved, wait=True)
    target = {"a": torch.ones(3), "b": {"c": torch.ones(2, 2)}}
    if match is None:
        assert torch.equal(ckpt.restore(target)["a"], torch.zeros(3))
    else:
        with pytest.raises(ValueError, match=match):
            ckpt.restore(target)


def test_an_unstepped_optimizer_is_compatible_with_a_stepped_one():
    """An Adam that never stepped holds no moments, so leaf counts differ
    between a fresh controller and a trained one; the comparison leaves the
    optimizers to their own ``load_state_dict``."""
    p = torch.nn.Parameter(torch.ones(3))
    fresh = torch.optim.Adam([p])
    stepped = torch.optim.Adam([p])
    p.sum().backward()
    stepped.step()
    assert len(fresh.state_dict()["state"]) != len(stepped.state_dict()["state"])
    C.check_compatible({"optimizer": stepped.state_dict()},
                       {"optimizer": fresh.state_dict()})
    C._load_optimizer(fresh, C.to_host({"o": stepped.state_dict()})["o"])
    assert torch.equal(fresh.state_dict()["state"][0]["exp_avg"],
                       stepped.state_dict()["state"][0]["exp_avg"])


# ---------------------------------------------------------- the controller
@pytest.fixture(scope="module")
def halfway(tmp_path_factory):
    """A run stopped after 4 iterations, with checkpoints every 2."""
    run_dir = tmp_path_factory.mktemp("halfway")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctl = _learn(run_dir, "--total_timesteps", "16", "--checkpoint_freq", "2")
    finally:
        torch.set_num_threads(n)
    return run_dir, ctl


def _copy_run(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return dst


def test_controller_checkpoint_roundtrip(tmp_path, halfway):
    src, ctl = halfway
    run_dir = _copy_run(src, tmp_path / "run")
    assert ctl.iteration == 4 and ctl.ckpt.latest_step() == 4
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["2.pt", "4.pt"]

    # A fresh controller restores the snapshot ...
    ctl2 = _controller(run_dir, "--total_timesteps", "20", "--checkpoint_freq", "2",
                       "--resume")
    assert ctl2.restored and ctl2.iteration == 4
    assert ctl2.num_pol_updates == ctl.num_pol_updates
    assert ctl2.num_ensemble_updates == ctl.num_ensemble_updates
    _assert_same(C.controller_state(ctl2), C.controller_state(ctl))
    # ... into its own modules, whose parameters are still views of the
    # stacked state that the fit writes, and which its optimizers still
    # point at ...
    flat = ctl2.fit_state.params
    assert flat is ctl2.ensemble.params
    for i, member in enumerate(ctl2.ensemble.members):
        for p in member.parameters():
            assert p.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
            offset = p.storage_offset() - flat.storage_offset()
            assert i * flat.shape[1] <= offset < (i + 1) * flat.shape[1]
    params = {id(p) for g in ctl2.sac_state.policy_opt.param_groups for p in g["params"]}
    assert params == {id(p) for p in ctl2.sac_state.policy.parameters()}
    # ... and it can go on learning.
    before = [p.clone() for p in ctl2.sac_state.policy.parameters()]
    ctl2.learn()
    ctl2.logger.finish()
    assert ctl2.iteration == 6 and ctl2.ckpt.latest_step() == 6
    assert any(not torch.equal(a, b)
               for a, b in zip(before, ctl2.sac_state.policy.parameters()))
    assert [r["iteration"] for r in _records(run_dir)] == list(range(6))
    assert [r["_step"] for r in _records(run_dir)] == list(range(6))


def test_metrics_append_tracks_actual_restore(tmp_path, halfway):
    """``--resume`` with nothing to restore must not append a restarted run
    onto an old metrics stream: the old stream is backed up and a fresh one
    started.  A resume that did restore appends."""
    run_dir = tmp_path / "run"
    lg = MetricsLogger(str(run_dir))
    lg.log({"iteration": 7})
    lg.finish()

    ctl = _controller(run_dir, "--resume")
    ctl.logger.finish()
    assert not ctl.restored and ctl.iteration == 0
    baks = [f for f in os.listdir(run_dir) if f.startswith("metrics.jsonl.bak")]
    assert len(baks) == 1
    assert os.path.getsize(run_dir / "metrics.jsonl") == 0
    assert b'"iteration": 7' in open(run_dir / baks[0], "rb").read()

    # An actual restore keeps the stream and makes no backup.
    restored_dir = _copy_run(halfway[0], tmp_path / "restored")
    size = os.path.getsize(restored_dir / "metrics.jsonl")
    ctl = _controller(restored_dir, "--resume")
    ctl.logger.finish()
    assert ctl.restored
    assert not [f for f in os.listdir(restored_dir) if f.startswith("metrics.jsonl.bak")]
    assert os.path.getsize(restored_dir / "metrics.jsonl") == size


@pytest.mark.parametrize("flags, match", [
    (["--hidden_size", "64"], r"sac_state'\]\['policy'\]"),
    (["--num_envs", "4"], r"\['row_of_env'\] is \(2,\)"),
    (["--num_dynamics_models", "3"], r"\['members'\] is not a sequence of 3"),
])
def test_mismatched_checkpoint_raises(tmp_path, halfway, flags, match):
    run_dir = _copy_run(halfway[0], tmp_path / "run")
    with pytest.raises(ValueError, match=match):
        _controller(run_dir, "--resume", *flags)
    # The refused resume touched neither the stream nor the checkpoints.
    assert not [f for f in os.listdir(run_dir) if f.startswith("metrics.jsonl.bak")]
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["2.pt", "4.pt"]


def test_a_snapshot_follows_the_pending_record(tmp_path):
    """Under the fused iteration a record waits one iteration for its pull;
    a checkpoint commits it first, so a resumed stream misses no record."""
    ctl = _controller(tmp_path, "--total_timesteps", "14", "--checkpoint_freq", "1")
    assert ctl.fused
    seen = []
    save = ctl.ckpt.save

    def checked(step, state, **kwargs):
        seen.append((step, ctl._pending_log is None, ctl.logger._step))
        return save(step, state, **kwargs)

    ctl.ckpt.save = checked
    try:
        ctl.learn()
    finally:
        ctl.logger.finish()
    # Iteration 0 retrains; 1 and 2 are pulled late, each committed by the
    # snapshot after it.
    assert seen == [(1, True, 1), (2, True, 2), (3, True, 3)]
    records = _records(tmp_path)
    assert [r["iteration"] for r in records] == [0, 1, 2]
    assert all("t_ready" in r for r in records[1:])


def test_resumed_run_equals_the_uninterrupted_run(tmp_path, halfway):
    """8 iterations in one go against 4, a new controller with ``--resume``,
    and 4 more: every field of every record that does not read the clock,
    and every tensor of the final state, are equal exactly."""
    whole = _learn(tmp_path / "whole", "--total_timesteps", "24")
    run_dir = _copy_run(halfway[0], tmp_path / "run")
    resumed = _learn(run_dir, "--total_timesteps", "24", "--checkpoint_freq", "2",
                     "--resume")
    assert whole.iteration == resumed.iteration == 8

    def strip(record):
        return {k: v for k, v in record.items()
                if k not in WALL_CLOCK and not k.startswith("t_")}

    a, b = _records(tmp_path / "whole"), _records(run_dir)
    assert [r["iteration"] for r in b] == list(range(8))
    # Both ran the default fused route: the non-retrain records were pulled
    # one iteration late, across the restart too.
    assert whole.fused and resumed.fused
    assert [i for i, r in enumerate(b) if "t_ready" in r] == [1, 2, 3, 5, 6, 7]
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert strip(ra) == strip(rb), ra["iteration"]
    # The resumed run did not warm up or evaluate again.
    assert "t_warmup_collect" in b[0] and "t_warmup_collect" not in b[4]
    assert int(resumed.replay.total_steps) == int(whole.replay.total_steps) == 24
    _assert_same(C.controller_state(resumed), C.controller_state(whole))
    # The artifacts of the iterations after the restart are the same too.
    for name in ("eval_4.npz", "surrogate_eval_4.npz"):
        with np.load(tmp_path / "whole" / "evaluation" / name) as za, \
                np.load(run_dir / "evaluation" / name) as zb:
            assert set(za.files) == set(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
