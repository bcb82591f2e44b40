"""The twin: the port's ``learn()`` held to the JAX package's, iteration by
iteration, on one tape of draws, in float64.

Both packages run ``tests/twin_tape.py``'s configuration (the flagship's
structure at a tiny size: a random warmup and its evaluation, 10
iterations with retrains at 0 and 5, members stopping early in the first, the horizon
climbing 2 -> 3, a world replay that wraps, SAC updates on mixed batches,
evaluations at iterations 0, 4 and 8) from the same flax weights, in
float64, with every draw taken from the tape by what it means
(``PORTMAP.md``'s draw-site table).  The JAX package runs its eager routes
in a process of its own (``tests/jax_twin.py``), started first so that it
overlaps the port, which runs its default route (the fused iteration, the
lock-step fit).  Every field both write to ``metrics.jsonl`` (the clock's
excepted) must agree after every iteration, and at the end the SAC
networks and their Adam states, every member and its Adam state, the
elites, both replays, the transforms' running statistics and the envs, all
to 1e-9 relative and 1e-12 absolute.

The checks are helpers that take the twin, so that
``test_torch_twin_latent.py`` and ``test_torch_twin_burgers.py`` hold the
other configurations of ``twin_tape.TWINS`` to the same checks, each in a
file of its own (``twin_fixtures``).
"""

import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.sac.sac import SAC as JSAC
from pdecontrol_tpu.sac.sac import SACConfig as JSACConfig
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.models import factories
from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig

from . import twin_tape as T

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-9, 1e-12
JAX_TIMEOUT = 240


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nested(flat, prefix):
    """``prefix/a/b/c`` entries of an npz as a nested dict of arrays."""
    out = {}
    for key in flat.files:
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return out


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _wait_for(path, proc):
    deadline = time.time() + JAX_TIMEOUT
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(proc.communicate()[1][-4000:])
        assert time.time() < deadline, "the JAX side wrote no weights"
        time.sleep(0.05)


# XLA's lowest optimisation: the JAX side compiles more than it runs.
XLA_FLAGS = "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"


def twin_fixtures(name, xla_flags=XLA_FLAGS):
    """The module-scoped fixtures of the twin ``name``: ``jax_side``, the
    JAX package's run under ``xla_flags``, started before the module's
    first test so that it overlaps the rest (it yields its directory and
    process), and ``twin``, both runs (the port's here)."""

    @pytest.fixture(scope="module", autouse=True)
    def jax_side(tmp_path_factory):
        out = tmp_path_factory.mktemp("twin")
        jax_dir = out / "jax"
        jax_dir.mkdir()
        env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1", XLA_FLAGS=xla_flags)
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "jax_twin.py"), str(jax_dir), name],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        yield out, jax_dir, proc
        if proc.poll() is None:
            proc.kill()
            proc.communicate()

    @pytest.fixture(scope="module")
    def twin(jax_side):
        out, jax_dir, proc = jax_side
        spec = T.TWINS[name]
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            _wait_for(jax_dir / "weights.npz", proc)
            weights = np.load(jax_dir / "weights.npz")
            members = [convert.state_dict(_nested(weights, f"member{i}"))
                       for i in range(spec.config["num_dynamics_models"])]
            sac = (convert.state_dict(_nested(weights, "policy")),
                   convert.state_dict(_nested(weights, "critic")))
            port = T.run_port(name, str(out / "port"), "cpu", torch.float64,
                              members=members, sac=sac)
            _, stderr = proc.communicate(timeout=JAX_TIMEOUT)
            assert proc.returncode == 0, stderr[-4000:]
        finally:
            torch.set_num_threads(n)
        with open(jax_dir / "tape.json") as f:
            jax_tape = json.load(f)
        return types.SimpleNamespace(
            name=name, spec=spec, ctl=port["ctl"], tape=port["tape"], fits=port["fits"],
            rollouts=port["rollouts"], records=port["records"],
            jax_records=_records(jax_dir / "run"), jax=np.load(jax_dir / "state.npz"),
            jax_tape=jax_tape)

    return jax_side, twin


jax_side, twin = twin_fixtures("flagship")


def _innermost(qualname):
    """The innermost function of a qualified name."""
    return [n for n in qualname.split(".") if not n.startswith("<")][-1]


def test_site_table_lists_every_draw_call():
    """Every call of a draw function in the modules of the MBPO path of
    either package is a site of the table (by file, function and draw
    function): a draw added later without a tape key fails here, as well
    as in the twin when it fires."""
    import ast

    calls = {T.JAX_PACKAGE: ("jax.random", {"uniform", "normal", "randint", "categorical"}),
             T.PORT_PACKAGE: ("torch", {"rand", "randn", "randint", "multinomial"})}
    modules = ("mbrl/controller.py", "mbrl/agents.py", "mbrl/world.py", "data/replay.py",
               "envs/kuramoto.py", "envs/burgers.py", "models/surrogate.py", "sac/nets.py",
               "sac/sac.py", "train/trainer.py", "parallel/sharded.py")
    for pkg, (base, names) in calls.items():
        listed = {(f, _innermost(q), c) for site in T.read_sites()
                  for f, _, q, c in (site.jax if pkg == T.JAX_PACKAGE else site.port)}
        for mod in modules:
            with open(os.path.join(T.ROOT, pkg, mod)) as f:
                tree = ast.parse(f.read())
            for fn, callee, line in _draw_calls(tree, base, names):
                assert (mod, fn, callee) in listed, (pkg, mod, line)


def _draw_calls(tree, base, names):
    """(innermost function, draw function, line) of each ``base.name(...)``
    call in ``tree``."""
    import ast

    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.FunctionDef):
                visit(child, child.name)
                continue
            if (isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute)
                    and child.func.attr in names and ast.unparse(child.func.value) == base):
                out.append((fn, child.func.attr, child.lineno))
            visit(child, fn)

    visit(tree, None)
    return out


def test_sac_nets_promote_as_flax_dense():
    """The SAC networks compute in the wider of their input's and their
    parameters' dtypes, as flax's ``Dense`` does: float32 parameters on a
    float64 observation (the controller's actions in a float64 env), and
    float64 parameters on a float32 batch (the update's cast), against the
    JAX package's ``select_action`` and critic."""
    rng = np.random.default_rng(0)
    obs = rng.uniform(-1, 1, (5, 1, 16))
    jsac = JSAC((1, 16), (1, 4), JSACConfig(hidden=32))
    jst = jax.jit(jsac.init)(jax.random.PRNGKey(0))
    select = jax.jit(lambda st, x: jsac.select_action(st, x, jax.random.PRNGKey(1),
                                                      deterministic=True))
    critic = jax.jit(lambda p, x, a: jsac.critic.apply({"params": p}, x, a))
    tsac = SAC((1, 16), (1, 4), SACConfig(hidden=32))
    for p_dtype, jp, obs_dtype in ((torch.float32, np.float32, np.float64),
                                   (torch.float64, np.float64, np.float32)):
        tst = tsac.init(p_dtype)
        jp_policy = jax.tree.map(lambda x: np.asarray(x, jp), jst.policy_params)
        jp_critic = jax.tree.map(lambda x: np.asarray(x, jp), jst.critic_params)
        tst.policy.load_state_dict(convert.state_dict(jp_policy))
        tst.critic.load_state_dict(convert.state_dict(jp_critic))
        x = obs.astype(obs_dtype)
        ja = select(jst.replace(policy_params=jp_policy), jnp.asarray(x))
        ta = tsac.select_action(tst, torch.as_tensor(x), deterministic=True)
        assert ta.dtype == torch.float64 and np.asarray(ja).dtype == np.float64
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-12, atol=1e-14)
        jq = critic(jp_critic, jnp.asarray(x), ja)
        tq = tst.critic(torch.as_tensor(x), ta)
        for t, j in zip(tq, jq):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-12, atol=1e-14)


def _close(port, jax_value, what):
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(jax_value, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def check_paths(twin):
    """The run reaches what makes the twin worth having: its iterations at
    their horizons (the horizon climbs), two retrains, in one of which
    early stopping fires for members at different epochs, a world replay
    that wraps, the evaluations, and the counters of the JAX package's
    run."""
    ctl, records, spec = twin.ctl, twin.records, twin.spec
    iters = [r for r in records if "iteration" in r]
    assert [r["iteration"] for r in iters] == list(range(spec.iterations))
    assert [r["horizon"] for r in iters] == list(spec.horizons)
    retrains = [r for r in records if "num_ensemble_updates" in r]
    assert [r["iteration"] for r in retrains] == list(spec.retrains)
    max_steps = [ctl.train_cfgs["initial" if i == 0 else "iterations"].max_steps
                 for i in range(len(twin.fits))]
    assert any(len(set(f)) == len(f) and min(f) < top
               for f, top in zip(twin.fits, max_steps)), twin.fits
    assert int(ctl.world_replay.next_row) > ctl.world_replay.num_rows  # wrapped
    assert [r["iteration"] for r in records if "eval_return_mean" in r] == list(spec.evals)
    assert all(0 < r["world_buffer_samples"] for r in iters)
    assert ctl.iteration == twin.jax_tape["iteration"]
    assert ctl.num_pol_updates == twin.jax_tape["num_pol_updates"]
    assert ctl.num_ensemble_updates == twin.jax_tape["num_ensemble_updates"]


def test_the_run_reaches_the_flagship_paths(twin):
    check_paths(twin)
    # In the first retrain early stopping fires, for members at different
    # epochs, before max_steps stops the last.
    first = sorted(twin.fits[0])
    assert first[0] < first[1] < first[2] == twin.ctl.train_cfgs["initial"].max_steps, twin.fits


def check_record(twin, index):
    """The record of iteration ``index`` (the first carries the warmup's
    evaluation and the first retrain): the same fields, the same values."""
    port, jax_rec = (T.shared_fields(r[index]) for r in (twin.records, twin.jax_records))
    assert port.pop("_step") == jax_rec.pop("_step") == index
    assert port.keys() == jax_rec.keys(), set(port) ^ set(jax_rec)
    parted = {}
    for k, v in jax_rec.items():
        a, b = np.asarray(port[k], np.float64), np.asarray(v, np.float64)
        if not np.allclose(a, b, rtol=RTOL, atol=ATOL):
            parted[k] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), ATOL)))
    assert not parted, f"iteration {index}: the fields that part, relative gaps: {parted}"


@pytest.mark.parametrize("index", range(T.TWINS["flagship"].iterations))
def test_records_agree_iteration_by_iteration(twin, index):
    check_record(twin, index)


def _sac_checks(twin):
    ctl, j = twin.ctl, twin.jax
    st = ctl.sac_state
    for name, net in (("policy", st.policy), ("critic", st.critic), ("target", st.target)):
        want = convert.state_dict(_nested(j, f"sac/{name}"))
        for k, v in net.state_dict().items():
            _close(v, want[k], f"sac {name} {k}")
    for name, net, opt in (("policy", st.policy, st.policy_opt),
                           ("critic", st.critic, st.critic_opt)):
        mu = convert.state_dict(_nested(j, f"sac/{name}_mu"))
        nu = convert.state_dict(_nested(j, f"sac/{name}_nu"))
        for k, p in net.named_parameters():
            state = opt.state[p]
            _close(state["exp_avg"], mu[k], f"sac {name} Adam mu {k}")
            _close(state["exp_avg_sq"], nu[k], f"sac {name} Adam nu {k}")
            assert int(state["step"]) == int(j[f"sac/{name}_count"])
    _close(st.log_alpha.detach(), j["sac/log_alpha"], "log_alpha")
    assert st.updates == int(j["sac/updates"])


def _member_checks(twin):
    ctl, j = twin.ctl, twin.jax
    modules = [factories.make(twin.spec.config["factory"], delta=ctl.env.delta,
                              **{**ctl.env.scenario, **ctl.config.model}).double()
               for _ in range(ctl.config.num_dynamics_models)]
    want = convert.stacked_trainer_state(
        modules, _nested(j, "members/params"), _nested(j, "members/mu"),
        _nested(j, "members/nu"), j["members/count"], j["members/global_step"])
    got = ctl.fit_state
    for name in ("params", "exp_avg", "exp_avg_sq"):
        _close(getattr(got, name), getattr(want, name), f"members' {name}")
    assert got.count.tolist() == want.count.tolist()
    assert got.global_step.tolist() == want.global_step.tolist()
    # The ensemble the world model rolls out holds the members' parameters.
    ens = convert.stacked_trainer_state(
        modules, _nested(j, "ensemble"), _nested(j, "members/mu"),
        _nested(j, "members/nu"), j["members/count"], j["members/global_step"])
    _close(ctl.ensemble.params, ens.params, "the ensemble's parameters")


def _elite_checks(twin):
    assert twin.ctl.ensemble.elite_mask.tolist() == twin.jax["elite_mask"].tolist()


def _replay_checks(twin):
    for name in ("replay", "world_replay"):
        rep = getattr(twin.ctl, name)
        for f in ("obs_seq", "actions", "rewards", "terminated", "truncated", "steps", "fill",
                  "complete", "row_of_env", "next_row", "total_steps"):
            _close(getattr(rep, f), twin.jax[f"{name}/{f}"], f"{name}.{f}")


def _transform_checks(twin):
    tr = twin.ctl.tr
    _close(tr.oscaling.vmin, twin.jax["oscaling/vmin"], "oscaling.vmin")
    _close(tr.oscaling.vmax, twin.jax["oscaling/vmax"], "oscaling.vmax")
    for f in ("mean", "var", "count"):
        _close(getattr(tr.undscaling, f), twin.jax[f"undscaling/{f}"], f"undscaling.{f}")


def _env_checks(twin):
    _close(twin.ctl.env_state.u, twin.jax["env/u"], "env u")
    assert twin.ctl.env_state.step.tolist() == twin.jax["env/step"].tolist()


FINAL = {"sac": _sac_checks, "members": _member_checks, "elites": _elite_checks,
         "replays": _replay_checks, "transforms": _transform_checks, "envs": _env_checks}


@pytest.mark.parametrize("part", list(FINAL))
def test_final_state_agrees(twin, part):
    FINAL[part](twin)


def check_same_keys(twin):
    """The port drew every key the JAX package drew, but the world step's
    reset at a round's last step, which JAX discards and the port skips."""
    port = {tuple(k) for k in twin.tape.keys}
    jax_keys = {tuple(k) for k in twin.jax_tape["keys"]}
    assert len(port) == len(twin.tape.keys)  # no key drawn twice
    assert port <= jax_keys
    extra = jax_keys - port
    assert extra and all(k[0] == "imagine" and k[3] == "reset" and k[5] == h - 1
                         for k in extra for h in [twin.spec.horizons[k[1]]]), sorted(extra)[:5]


def test_both_drew_from_the_same_keys(twin):
    check_same_keys(twin)


def check_sites_fired(twin):
    """The sites that drew in each package are the table's, and the
    packages drew at the same roles."""
    fired = {pkg: {tuple(s[1:]) for s in sites}
             for pkg, sites in ((T.PORT_PACKAGE, twin.tape.fired),
                                (T.JAX_PACKAGE, map(tuple, twin.jax_tape["fired"])))}
    roles = {pkg: {s[0] for s in f} for pkg, f in fired.items()}
    assert roles[T.PORT_PACKAGE] == roles[T.JAX_PACKAGE]
    table = {s.role for s in T.read_sites()}
    assert roles[T.PORT_PACKAGE] <= table
    assert roles[T.PORT_PACKAGE] >= table - {"pool", "weights", "train_vis.index"}
    return fired


def test_every_draw_site_fired_has_a_tape_key(twin):
    check_sites_fired(twin)
