"""The port's mesh (``pdecontrol_tpu_torch/parallel/``) on the CPU: rank
processes through gloo, which meet at a rendezvous file under the test's
temporary directory (so no port is fixed under xdist), each with a time
limit.  The rank processes (``tests/torch_mesh_ranks.py``) import no JAX:
the JAX side is computed here and handed over as files.

  * the ranks' coordinates are the JAX package's device grid;
  * the three sharded steps at 2x2 against the JAX package's sharded steps on
    the 8-device CPU mesh of ``tests/conftest.py``, from the same inputs,
    converted parameters and injected SAC noise, in float64 at 1e-9;
  * the JAX package's divisibility errors, and a mesh without ranks.

The controller on the mesh is in ``tests/test_torch_parallel_learn.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pdecontrol_tpu.data.types import Sample as JSample
from pdecontrol_tpu.envs import kuramoto as jenv
from pdecontrol_tpu.envs.transforms import Identity as JIdentity
from pdecontrol_tpu.mbrl.config import MBPOConfig as JConfig
from pdecontrol_tpu.mbrl.controller import PDEModelBasedController as JController
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.parallel import mesh as jmesh
from pdecontrol_tpu.parallel import sharded as jsharded
from pdecontrol_tpu.sac.sac import SAC as JSAC
from pdecontrol_tpu.sac.sac import SACConfig as JSACConfig
from pdecontrol_tpu.train import trainer as JTrn
from pdecontrol_tpu.train.losses import mse_loss as j_mse
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController, mesh_for
from pdecontrol_tpu_torch.models import factories as TF
from pdecontrol_tpu_torch.parallel import mesh as tmesh
from pdecontrol_tpu_torch.parallel.dryrun import launch
from tests.torch_mesh_ranks import controller_config

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_ranks.py")
# Seconds a rank process may take (each takes 5-15 s here).
LIMIT = 120
M, B, SAC_ROWS = 4, 4, 32
# The lock-step step of every family is held to JAX in
# tests/test_torch_lockstep*.py; here the sharding is, on the family whose
# JAX program compiles fastest (the flagship's takes ~23 s here).  The
# flagship's sharded fit runs in tests/test_torch_parallel_learn.py.
FAMILY = "KSAutoRegFullyConnectedLSTM"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(mode, outdir, ranks=4):
    address = "file://" + os.path.join(outdir, "rendezvous")
    cmds = [[sys.executable, RANKS, mode, str(i), str(ranks), address, str(outdir),
             "--platform", "cpu"] for i in range(ranks)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return launch(cmds, LIMIT, str(outdir), env=env)


def _close(got, want, tol=1e-9):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


# ------------------------------------------------------------------ layout
def test_rank_coordinates_are_the_jax_device_grid():
    grid = np.vectorize(lambda d: d.id)(jmesh.make_mesh(8, model_parallel=2).devices)
    np.testing.assert_array_equal(tmesh.rank_grid(8, 2), grid)
    for rank in range(8):
        m = tmesh.Mesh(4, 2, rank, groups={})
        assert grid[m.data_index, m.model_index] == rank
        assert m.data_slice(8) == slice(2 * m.data_index, 2 * m.data_index + 2)
        assert m.model_slice(6) == slice(3 * m.model_index, 3 * m.model_index + 3)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.Mesh(4, 2, 0, groups={}).data_slice(6)


# ----------------------------------------------------------- sharded steps
def _adam(opt_state):
    (adam,) = [s for s in opt_state if hasattr(s, "mu")]
    return adam


def _port_tensors(jstate):
    """A JAX stacked TrainerState in the port's [M, P] layout."""
    adam = _adam(jstate.opt_state)
    modules = [TF.make(FAMILY, delta=0.25, N=16).double()
               for _ in range(M)]
    return convert.stacked_trainer_state(modules, _np(jstate.params), _np(adam.mu),
                                         _np(adam.nu), np.asarray(adam.count),
                                         np.asarray(jstate.global_step)).tensors()


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """The JAX package's three sharded steps on its 8-device mesh, and the
    port's at 2x2 in four rank processes, on the same inputs."""
    out = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    mesh = jmesh.make_mesh(8, model_parallel=2)
    inputs, want = {}, {}

    # The env batch over data: 3 steps, none of which resets.
    env = jenv.KuramotoSivashinsky.create(n=16, cfg_steps=4, dtype=jnp.float64)
    u = rng.uniform(-1, 1, (B, 16))
    actions = rng.uniform(-1, 1, (3, B, 1, 4))
    pool = rng.uniform(-0.4, 0.4, (8, 16))
    state = env.reset_from_pool(jax.random.PRNGKey(0), jnp.asarray(pool), (B,))
    state = state.replace(u=jnp.asarray(u))
    collect, place = jsharded.sharded_collect_fn(mesh, env, nsteps=3)
    jstate, rewards = collect(*place(state, jnp.asarray(actions), jnp.asarray(pool)))
    inputs.update(collect_u=u, collect_actions=actions, pool=pool)
    want.update(collect_rewards=rewards, collect_u=jstate.u)

    # The members over model: one lock-step step of 4 members.
    jm = JF.make(FAMILY, delta=0.25, N=16)
    jtr = JTrn.SurrogateTrainer(jm, j_mse, JTrn.TrainConfig(tau=2, tbtt=3, batch_size=B))
    x = jnp.zeros((1, 2, 1, 16))
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), x, x)["params"])
    params = jax.tree.map(lambda p: jnp.asarray(p[None] + 0.02 * rng.normal(size=(M,) + p.shape)),
                          params)
    opt_state = tuple(s._replace(count=jnp.zeros((M,), jnp.int32)) if hasattr(s, "mu") else s
                      for s in jtr.opt.init(params))
    stacked = JTrn.TrainerState(params=params, opt_state=opt_state,
                                global_step=jnp.zeros((M,), jnp.int32))
    states = rng.normal(size=(M, B, 5, 1, 16))
    acts = rng.uniform(-1, 1, (M, B, 5, 1, 16))
    train, place = jsharded.sharded_ensemble_train_fn(mesh, jtr)
    new, metrics = train(*place(stacked, jnp.asarray(states), jnp.asarray(acts)), JIdentity(),
                         jnp.asarray(1e-3))
    names = ("params", "exp_avg", "exp_avg_sq", "count", "global_step")
    inputs.update(train_states=states, train_actions=acts,
                  **{f"train_{k}": t.numpy() for k, t in zip(names, _port_tensors(stacked))})
    want.update(train_loss=metrics["train_loss"],
                **{f"train_{k}": t.numpy() for k, t in zip(names, _port_tensors(new))})

    # The batch over data: one SAC update with the JAX update's own noise.
    jsac = JSAC((1, 16), (1, 4), JSACConfig(hidden=32))
    sac_state = jsac.init(jax.random.PRNGKey(2))
    p, c = (jax.tree.map(lambda a: a.astype(jnp.float64), t)
            for t in (sac_state.policy_params, sac_state.critic_params))
    log_alpha = jnp.zeros((), jnp.float64)
    sac_state = sac_state.replace(
        policy_params=p, critic_params=c, target_params=c,
        policy_opt=jsac.optimizer.init(p), critic_opt=jsac.optimizer.init(c),
        log_alpha=log_alpha, alpha_opt=jsac.optimizer.init(log_alpha))
    batch = dict(obs=rng.normal(size=(SAC_ROWS, 1, 16)),
                 actions=rng.uniform(-1, 1, (SAC_ROWS, 1, 4)),
                 nxtobs=rng.normal(size=(SAC_ROWS, 1, 16)),
                 rewards=rng.normal(size=(SAC_ROWS,)),
                 terminated=rng.uniform(size=SAC_ROWS) < 0.25,
                 truncated=np.zeros(SAC_ROWS, bool), steps=np.zeros(SAC_ROWS, np.int32))
    key = jax.random.PRNGKey(3)
    knext, kpi = jax.random.split(key)
    noise = [np.asarray(jax.random.normal(k, (SAC_ROWS, 1, 4), jnp.float64))
             for k in (knext, kpi)]
    torch.save({name: convert.state_dict(jax.tree.map(np.asarray, params))
                for name, params in (("policy", p), ("critic", c), ("target", c))},
               out / "sac_state.pt")
    update, place = jsharded.sharded_sac_update_fn(mesh, jsac)
    jsac_state, jm_ = update(*place(sac_state, JSample(**{k: jnp.asarray(v)
                                                         for k, v in batch.items()})), key)
    inputs.update({f"sac_{k}": v for k, v in batch.items()},
                  sac_noise_next=noise[0], sac_noise_pi=noise[1])
    want.update(sac_qf_loss=jm_["qf_loss"], sac_policy_loss=jm_["policy_loss"])
    for name, params in (("policy", jsac_state.policy_params),
                         ("critic", jsac_state.critic_params),
                         ("target", jsac_state.target_params)):
        for k, v in convert.state_dict(jax.tree.map(np.asarray, params)).items():
            want[f"sac_{name}.{k}"] = v.numpy()

    np.savez(out / "inputs.npz", family=FAMILY, **inputs)
    run_ranks("sharded", out)
    got = [dict(np.load(out / f"sharded{i}.npz")) for i in range(4)]
    return got, {k: np.asarray(v) for k, v in want.items()}


def _check(sharded_steps, prefix):
    got, want = sharded_steps
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    for k in keys:
        for rank in got[1:]:
            np.testing.assert_array_equal(rank[k], got[0][k], err_msg=k)  # replicated
        assert got[0][k].shape == want[k].shape, k
        _close(got[0][k], want[k])


def test_sharded_collect_matches_jax(sharded_steps):
    _check(sharded_steps, "collect_")


def test_sharded_ensemble_train_step_matches_jax(sharded_steps):
    _check(sharded_steps, "train_")


def test_sharded_sac_update_matches_jax(sharded_steps):
    _check(sharded_steps, "sac_")


# ------------------------------------------------------------------ checks
def _jax_error(**kw):
    with pytest.raises(ValueError) as err:
        JController(JConfig(**kw))
    return str(err.value)


@pytest.mark.parametrize("kw", [
    dict(data_parallel=2, num_envs=3),
    dict(data_parallel=2, num_envs=4, model_rollouts_batch_size=5),
    dict(data_parallel=2, num_envs=4, model_rollouts_batch_size=4, policy_batch_size=7),
    dict(model_parallel=2, num_dynamics_models=3),
], ids=["num_envs", "model_rollouts_batch_size", "policy_batch_size",
        "num_dynamics_models"])
def test_divisibility_errors_are_the_jax_package_s(kw, tmp_path):
    cfg = dict(run_dir=str(tmp_path), env_config={"n": 16, "cfg_steps": 5, "t_max": 0.04},
               **kw)
    want = _jax_error(**cfg)
    assert "not divisible by its mesh axis size" in want
    with pytest.raises(ValueError) as err:
        mesh_for(controller_config(**{**cfg, "env_config": cfg["env_config"]}))
    assert str(err.value) == want


def test_a_mesh_needs_its_ranks(tmp_path):
    """Without a process group the mesh names the flags that start one; with
    a group of another size it says how many devices it needs."""
    cfg = controller_config(str(tmp_path), data_parallel=2)
    with pytest.raises(ValueError, match="--coordinator_address.*--num_processes.*"
                                         "--process_id"):
        PDEModelBasedController(cfg, device="cpu")
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "rendezvous"),
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, found 1"):
            mesh_for(cfg)
    finally:
        dist.destroy_process_group()
