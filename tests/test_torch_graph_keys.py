"""The keys of the port's CUDA graphs against the JAX package's jit caches,
on the CPU.  A recording stand-in for ``utils.graphs.GraphCache`` runs every
body eagerly and notes the key of each graph that the route would capture
or replay; a tiny ``learn()`` of the MBPO controller (with
``--no_fuse_iteration``, and by default), a tiny ``learn()`` of the SAC
baseline and a tiny one-member ``fit`` then hold the same keys as the JAX
package's ``_collect_jit``, ``_world_jit``, ``_policy_jit``,
``_sur_eval_jit``, ``_chunk_jit`` and ``_train_jit`` after the same runs
(``tests/jax_graph_keys.py``, in a process of its own).  The random warmups
run eagerly on purpose, so the JAX keys of their programs have no graph."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.envs.transforms import Identity, SampleTransform
from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
from pdecontrol_tpu_torch.models import factories
from pdecontrol_tpu_torch.sac import train as sac_train
from pdecontrol_tpu_torch.train.losses import make_loss
from pdecontrol_tpu_torch.train.schedulers import Scheduler
from pdecontrol_tpu_torch.train.trainer import SurrogateTrainer, TrainConfig
from pdecontrol_tpu_torch.utils.logging import MetricsLogger

from .jax_graph_keys import FIT, MBPO_ARGS, SAC_ARGS

HERE = os.path.dirname(os.path.abspath(__file__))


class RecordingCache:
    """``GraphCache``'s interface on the CPU: nothing is captured, every
    body runs eagerly, and ``keys`` lists the key of every graph asked for."""

    def __init__(self, generators):
        self.generators = list(generators)
        self.keys = []

    def get(self, key):
        return None

    def capture(self, key, body, state):
        self.keys.append(key)
        return types.SimpleNamespace(seconds=0.0, pool_bytes=0)

    def run(self, key, body, state, what, counters=(), captured=None):
        self.keys.append(key)
        return body()


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """The JAX runs, started first so that they overlap the port's."""
    out = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "jax_graph_keys.py"), str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    done = {}

    def result():
        if not done:
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr[-4000:]
            done.update(json.loads(stdout.strip().splitlines()[-1]))
        return done

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tuples(keys):
    return {tuple(k) if isinstance(k, list) else (k,) for k in keys}


def _port_learn(run_dir, args):
    """The keys of the port's tiny MBPO ``learn()`` with ``args``."""
    parsed = script.build_parser().parse_args(
        args + ["--platform", "cpu", "--run_dir", str(run_dir)])
    parsed.env_config = json.dumps({**json.loads(parsed.env_config), "transient_time": 0.5})
    ctl = PDEModelBasedController(script.config_from_args(parsed), device="cpu")
    rec = ctl.graphs = ctl.trainer.graphs = RecordingCache([ctl.gen])
    try:
        ctl.learn()
    finally:
        ctl.logger.finish()
    return rec.keys


def test_mbpo_phase_keys_are_the_jax_programs(jax_keys, tmp_path):
    """Every phase of both iterations, the evaluations and the lock-step
    fit: ``collect`` as ``_collect_jit`` (steps, random; the JAX key's
    third field, whether the scaling updates, is always true in a
    ``learn()``), ``imagine`` as ``_world_jit``, ``update_policy`` as
    ``_policy_jit``, ``surrogate_rollout`` as ``_sur_eval_jit``, and the
    lock-step fit's step and validation step as the fields of its
    ``ens_fit`` program (length, members, tau, tbtt, batch)."""
    keys = _port_learn(tmp_path, MBPO_ARGS)
    by = {}
    for k in keys:
        by.setdefault(k[0], set()).add(k[1:])
    want = jax_keys()["mbpo"]
    assert by.keys() == {"collect", "world", "policy", "eval", "sur_eval", "fit_step",
                         "fit_val"}
    assert {k + (True,) for k in by["collect"]} == {
        k for k in _tuples(want["_collect_jit"]) if not k[1]}
    assert by["world"] == _tuples(want["_world_jit"])
    assert by["policy"] == _tuples(want["_policy_jit"])
    assert by["sur_eval"] == _tuples(want["_sur_eval_jit"])
    # (steps, episodes): the JAX package's one _eval_jit program.
    assert by["eval"] == {(8, 2)}
    ens_fit = {k[1:6] for k in _tuples(want["_train_jit"]) if k[0] == "ens_fit"}
    assert {(length, m, tau, tbtt, bs) for length, m, bs, tau, tbtt, _ in by["fit_step"]} \
        == ens_fit
    assert {(length, m, bs) for length, m, bs in by["fit_val"]} == {
        (k[0], k[1], k[4]) for k in ens_fit}


def test_default_route_graphs_the_phases_of_its_retrains_only(tmp_path):
    """By default iteration 0 (a retrain) runs the phase graphs and
    iteration 1 the fused iteration's, whose key names the same three
    programs: together they are the ``--no_fuse_iteration`` run's keys."""
    unfused = set(_port_learn(tmp_path / "unfused", MBPO_ARGS))
    default = _port_learn(tmp_path / "default",
                          [a for a in MBPO_ARGS if a != "--no_fuse_iteration"])
    fused = [k for k in default if isinstance(k[0], int)]
    assert fused == [(1, 2, 1, 2)]  # (rollout length, horizon, rounds, updates)
    derived = {("collect", 1, False), ("world", 2, 1), ("policy", 2)}
    assert {k for k in default if not isinstance(k[0], int)} | derived == unfused


def test_sac_chunk_keys_are_the_jax_programs(jax_keys, tmp_path):
    """The chunks of the policy as ``_chunk_jit`` (steps, random, updates
    per step); the random warmup's chunk runs eagerly, so its JAX key has no
    graph; the evaluation is keyed by its episodes' length."""
    args = sac_train.build_parser().parse_args(
        SAC_ARGS + ["--platform", "cpu", "--run_dir", str(tmp_path)])
    args.env_config = json.dumps({**json.loads(args.env_config), "transient_time": 0.5})
    trainer = sac_train.SACTrainer(args, device="cpu")
    rec = trainer.graphs = RecordingCache([trainer.gen])
    logger = MetricsLogger(args.run_dir, config=vars(args))
    try:
        trainer.learn(logger)
    finally:
        logger.finish()
    chunks = {k[1:] for k in rec.keys if k[0] == "chunk"}
    want = _tuples(jax_keys()["sac"]["_chunk_jit"])
    assert chunks == {k for k in want if not k[1]}
    assert {k for k in want if k[1]} == {(8, True, 0)}
    assert {k for k in rec.keys if k[0] != "chunk"} == {("evaluate", 8)}
    assert len([k for k in rec.keys if k[0] == "chunk"]) == 3


def test_one_member_fit_keys_are_the_jax_epochs(jax_keys):
    """Each epoch's TBPTT and validation steps at its window length, as the
    JAX package's ``_epoch_fn`` keys (length, tau, tbtt, batch)."""
    n, fill = FIT["N"], np.asarray(FIT["fill"], np.int32)
    rep = R.create(len(fill), 16, 2, (1, n), (1, n), torch.float32)
    rng = np.random.default_rng(0)
    rep.obs_seq.copy_(torch.as_tensor(rng.normal(size=tuple(rep.obs_seq.shape))))
    rep.actions.copy_(torch.as_tensor(rng.uniform(-1, 1, tuple(rep.actions.shape))))
    rep.fill.copy_(torch.as_tensor(fill))
    torch.manual_seed(0)
    tr = SurrogateTrainer(make_loss("MSELoss", {}), TrainConfig(**FIT["config"]))
    gen = torch.Generator().manual_seed(1)
    rec = tr.graphs = RecordingCache([gen])
    module = factories.make("KSAutoRegFullyConnectedLSTM", delta=0.25, N=n)
    train = torch.as_tensor(np.asarray(FIT["train"], bool))
    tr.fit(tr.init(module), rep, train, ~train & (rep.fill > 0), Identity(),
           SampleTransform(), Scheduler.factory(FIT["curriculum"]), 0, gen)
    want = {k[1:] for k in _tuples(jax_keys()["fit"]["_train_jit"]) if k[0] == "epoch"}
    steps = {(length, tau, tbtt, bs) for _, length, bs, tau, tbtt, _ in
             (k for k in rec.keys if k[0] == "fit_one_step")}
    vals = {k[1:] for k in rec.keys if k[0] == "fit_one_val"}
    assert steps == want
    assert vals == {(length, bs) for length, _, _, bs in want}
    assert len(want) == 3  # the curriculum grew the window twice
