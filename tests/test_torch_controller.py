"""Two pieces of the port's controller held to the JAX package on the same
inputs (numpy, from a seed):

  * the rollout half of ``evaluate_surrogate`` at an injected ``(row,
    start)`` against ``PDEModelBasedController._sur_eval_fn(h)``, in float64
    to 1e-9, with the flax parameters carried over by ``convert.py`` and one
    ensemble member, so that no elite draw enters;
  * ``update_surrogates``' train and val episode masks against JAX's on the
    same ``fill``, exactly, with both packages' ``fit_ensemble`` replaced by
    a recorder.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.data import replay as JR
from pdecontrol_tpu.envs import kuramoto as jenv
from pdecontrol_tpu.mbrl import controller as JC
from pdecontrol_tpu.mbrl.config import MBPOConfig as JConfig
from pdecontrol_tpu.mbrl.transform_sets import ControllerTransforms as JCT
from pdecontrol_tpu.mbrl.world import WorldModel as JWorld
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.models.surrogate import EnsembleState as JEns
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.mbrl.config import MBPOConfig
from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
from pdecontrol_tpu_torch.mbrl.transform_sets import ControllerTransforms

N, TAU, H, ROWS, ENVS = 16, 2, 4, 6, 2
ENV = {"n": N, "cfg_steps": 5, "t_max": 0.04}  # 8-step episodes
EP = 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(cls, run_dir, **over):
    base = dict(
        run_dir=str(run_dir), env_config=dict(ENV), num_envs=ENVS, total_timesteps=40,
        learning_starts=8, capacity=ROWS * EP, pool_size=8, surrogate_train_freq=8,
        policy_train_steps_per_sample=1, model_rollouts_per_sample=2,
        model_rollouts_batch_size=4, model_buffer_store_iterations=2,
        model_buffer_max_capacity=64, num_dynamics_models=1, num_elite_models=1,
        policy_batch_size=8, agent_eval_freq=4, num_eval_episodes=2,
        surrogate_eval_horizon=H, logging_freq=0, precompile_horizons=False,
        rollout_length_schedule={"scheduler": "ConstantLengthScheduler", "length": 2},
        training={"tau": TAU, "initial": {"tbtt": 4, "patience": 2, "batch_size": 4},
                  "iterations": {"tbtt": 4, "patience": 1, "batch_size": 4}},
        trainer={"initial": {"min_steps": 2, "max_steps": 6},
                 "iterations": {"min_steps": 1, "max_steps": 3}},
        curriculum={"scheduler": "ConstantLengthScheduler", "length": 3},
    )
    base.update(over)
    return cls(**base)


def _torch_controller(run_dir, **env_over):
    cfg = _config(MBPOConfig, run_dir)
    cfg.env_config.update(transient_time=0.5, **env_over)
    return PDEModelBasedController(cfg, device="cpu")


# ------------------------------------------------- evaluate_surrogate rollout
@pytest.mark.parametrize("row, start", [(1, 0), (4, 2)])
def test_surrogate_rollout_matches_jax(tmp_path, row, start):
    _surrogate_rollout_against_jax(tmp_path, row, start, int)


@pytest.mark.parametrize("row, start", [(1, 0), (4, 2)])
def test_surrogate_rollout_with_tensor_indices_matches_jax(tmp_path, row, start):
    """``row`` and ``start`` as 0-d tensors, as a CUDA graph of the rollout
    reads them (the JAX package passes them traced)."""
    _surrogate_rollout_against_jax(tmp_path, row, start, torch.tensor)


def _surrogate_rollout_against_jax(tmp_path, row, start, index):
    rng = np.random.default_rng(0)
    je = jenv.KuramotoSivashinsky.create(**ENV, dtype=jnp.float64)
    ctl = _torch_controller(tmp_path / "t", dtype=torch.float64)
    te = ctl.env
    assert te.max_episode_steps == je.max_episode_steps == EP

    # The same replay contents on both sides.
    obs_seq = rng.uniform(-1.5, 1.5, (ROWS, EP + 1, 1, N))
    actions = rng.uniform(te.action_low, te.action_high, (ROWS, EP, 1, 4))
    rewards = rng.normal(-1.0, 0.3, (ROWS, EP))
    steps = np.tile(np.arange(1, EP + 1, dtype=np.int32), (ROWS, 1))
    fill = np.full((ROWS,), EP, np.int32)
    jreplay = JR.create(ROWS, EP, ENVS, je.obs_shape, je.action_shape, jnp.float64).replace(
        obs_seq=jnp.asarray(obs_seq), actions=jnp.asarray(actions),
        rewards=jnp.asarray(rewards), steps=jnp.asarray(steps), fill=jnp.asarray(fill),
        complete=jnp.ones((ROWS,), bool))
    assert ctl.replay.obs_seq.shape == obs_seq.shape
    assert ctl.replay.obs_seq.dtype == torch.float64
    ctl.replay.obs_seq.copy_(torch.as_tensor(obs_seq))
    ctl.replay.actions.copy_(torch.as_tensor(actions))
    ctl.replay.rewards.copy_(torch.as_tensor(rewards))
    ctl.replay.steps.copy_(torch.as_tensor(steps))
    ctl.replay.fill.copy_(torch.as_tensor(fill))
    ctl.replay.complete.fill_(True)

    # Transforms with the same running statistics.
    seen = rng.uniform(-2, 2, (6, 1, N))
    deltas = rng.normal(0.1, 1.5, (5, 1, N))
    jtr = JCT.create(je, dtype=jnp.float64)
    jtr = jtr.replace(oscaling=jtr.oscaling.update(jnp.asarray(seen)),
                      undscaling=jtr.undscaling.update(jnp.asarray(deltas)))
    ttr = ControllerTransforms.create(te, dtype=torch.float64)
    ctl.tr = ttr.replace(oscaling=ttr.oscaling.update(torch.as_tensor(seen)),
                         undscaling=ttr.undscaling.update(torch.as_tensor(deltas)))

    # One member with the flax parameters, in float64 on both sides.
    jm = JF.make("KSAutoRegConvolutionalLSTM", delta=je.delta, N=N)
    window = jnp.asarray(rng.uniform(-1, 1, (1, TAU, 1, N)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), window, window)["params"]
    params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params)
    jens = JEns(params=jax.tree.map(lambda p: p[None], params),
                elite_mask=jnp.ones((1,), bool), num_elites=1)
    ctl.ensemble.members.double()
    ctl.ensemble.members[0].load_state_dict(
        convert.state_dict(jax.tree.map(np.asarray, params)), strict=True)

    # JAX's jitted rollout reads only ``tau`` and ``world`` of its controller.
    jctl = types.SimpleNamespace(
        tau=TAU, _sur_eval_jit={},
        world=JWorld(jm, 4, je.max_episode_steps, je.reward_fn, TAU))
    jout = JC.PDEModelBasedController._sur_eval_fn(jctl, H)(
        jax.random.PRNGKey(4), jens, jreplay, jtr,
        jnp.asarray(row, jnp.int32), jnp.asarray(start, jnp.int32))
    tout = ctl.surrogate_rollout(index(row), index(start), H)

    assert set(tout) == set(jout) == {"err", "hstep", "reward_err", "truth", "preds",
                                      "actions", "rtrue", "rpred"}
    for k in sorted(jout):
        j = np.asarray(jout[k])
        t = tout[k].numpy()
        assert t.shape == j.shape and t.dtype == j.dtype == np.float64, k
        np.testing.assert_allclose(t, j, rtol=1e-9, atol=1e-9, err_msg=k)
    assert tout["preds"].shape == (H, 1, N) and tout["hstep"].shape == (H,)
    assert float(tout["err"]) > 0


def test_evaluate_surrogate_draws_row_and_start_then_rolls_out(tmp_path, monkeypatch):
    """``evaluate_surrogate`` = two uniforms from the controller's generator
    mapped to (row, start), then ``surrogate_rollout`` at that pair."""
    ctl = _torch_controller(tmp_path / "t")
    ctl.collect(2 * EP + 3, random=True)  # two complete episodes per env
    fill = ctl.replay.fill.numpy()
    complete = ctl.replay.complete.numpy()
    rows = np.where(complete & (fill >= TAU + H))[0]
    assert len(rows) == 4
    u = torch.rand((2,), generator=torch.Generator().set_state(ctl.gen.get_state())).numpy()
    row = int(rows[min(int(u[0] * len(rows)), len(rows) - 1)])
    hi = EP - TAU - H
    start = min(int(u[1] * hi), hi - 1)

    calls = []
    real = ctl.surrogate_rollout

    def spy(r, s, h):
        calls.append((r, s, h))
        return real(r, s, h)

    monkeypatch.setattr(ctl, "surrogate_rollout", spy)
    out = ctl.evaluate_surrogate()
    # The pair goes in as 0-d tensors on the controller's device, which a
    # CUDA graph of the rollout reads.
    assert all(isinstance(x, torch.Tensor) and x.device == ctl.device for x in calls[0][:2])
    assert [(int(r), int(s), h) for r, s, h in calls] == [(row, start, H)]
    assert set(out) == {"surrogate_open_loop_mse", "reward_model_error"}
    assert all(np.isfinite(v) for v in out.values())


# --------------------------------------------------- update_surrogates' masks
@pytest.fixture(scope="module")
def controllers(tmp_path_factory):
    """One controller of each package at the same tiny size, each with its
    ``fit_ensemble`` replaced by a recorder of the masks it is given."""
    root = tmp_path_factory.mktemp("masks")
    n = torch.get_num_threads()
    torch.set_num_threads(1)

    # The reset pool plays no part in the split; the JAX controller's pool
    # (a 200-time-unit transient) is replaced by a cheap one.
    def cheap_pool(env, key, pool_size):
        return 0.1 * jax.random.normal(key, (pool_size, env.n), env.dtype)

    # The JAX controller initialises its ensemble eagerly (half a minute on
    # the CPU); the same initialisation under jit takes seconds.
    def jitted_init(module, key, num_members, states, actions, num_elites=None):
        keys = jax.random.split(key, num_members)
        params = jax.jit(jax.vmap(lambda k: module.init(k, states, actions)["params"]))(keys)
        return JEns(params=params, elite_mask=jnp.ones((num_members,), bool),
                    num_elites=num_elites or num_members)

    mp = pytest.MonkeyPatch()
    mp.setitem(JC.ENVS, "KuramotoSivashinskyEnv-v0", (jenv.KuramotoSivashinsky, cheap_pool))
    mp.setattr(JC, "init_ensemble", jitted_init)
    try:
        jctl = JC.PDEModelBasedController(_config(JConfig, root / "j", capacity=64 * EP,
                                                  num_dynamics_models=2,
                                                  num_elite_models=2))
        tctl = PDEModelBasedController(
            _config(MBPOConfig, root / "t", capacity=64 * EP, num_dynamics_models=2,
                    num_elite_models=2,
                    env_config={**ENV, "transient_time": 0.5}), device="cpu")
    finally:
        mp.undo()
        torch.set_num_threads(n)
    seen = {}

    def jax_fit(stacked, replay, train_mask, val_mask, *args, **kwargs):
        seen["jax"] = (np.asarray(train_mask), np.asarray(val_mask),
                       kwargs["host_hints"])
        return stacked, jnp.asarray([0.25, 0.5]), {}

    def torch_fit(states, replay, train_mask, val_mask, *args, **kwargs):
        seen["torch"] = (train_mask.numpy(), val_mask.numpy(), kwargs["host_hints"])
        return states, np.asarray([0.25, 0.5]), {}

    jctl.trainer.fit_ensemble = jax_fit
    tctl.trainer.fit_ensemble = torch_fit
    return jctl, tctl, seen


def _fills():
    rng = np.random.default_rng(5)
    many = np.zeros(64, np.int32)
    many[:40] = rng.integers(1, EP + 1, 40)  # complete, short and in-progress rows
    one_ok = np.zeros(64, np.int32)
    one_ok[[3, 9, 20]] = [2, EP, 4]  # a single row holds a window
    two_ok = np.zeros(64, np.int32)
    two_ok[[0, 1, 2, 3]] = [EP, 1, EP, 3]
    full = np.full(64, EP, np.int32)
    return {"many": many, "one_ok": one_ok, "two_ok": two_ok, "full": full}


@pytest.mark.parametrize("iteration", [0, 7])
@pytest.mark.parametrize("name", ["many", "one_ok", "two_ok", "full"])
@pytest.mark.parametrize("ratio", [0.1, 0.3])
def test_update_surrogates_masks_match_jax(controllers, name, iteration, ratio):
    jctl, tctl, seen = controllers
    fill = _fills()[name]
    assert jctl.replay.num_rows == tctl.replay.num_rows == 64
    jctl.replay = jctl.replay.replace(fill=jnp.asarray(fill))
    tctl.replay.fill.copy_(torch.as_tensor(fill))
    for ctl in (jctl, tctl):
        ctl.iteration = iteration
        ctl.config.val_split_ratio = ratio
    seen.clear()
    jlogs = jctl.update_surrogates()
    tlogs = tctl.update_surrogates()

    (jtrain, jval, jhints), (ttrain, tval, thints) = seen["jax"], seen["torch"]
    assert jtrain.dtype == ttrain.dtype == np.bool_ and jtrain.shape == ttrain.shape == (64,)
    np.testing.assert_array_equal(ttrain, jtrain)
    np.testing.assert_array_equal(tval, jval)
    for k in ("fill", "train_np", "val_np"):
        np.testing.assert_array_equal(np.asarray(thints[k]), np.asarray(jhints[k]))
    # The split itself: val rows hold a window, and no row with data is lost.
    length0 = TAU + 3
    assert tval.any() and (fill[tval] >= length0).all()
    np.testing.assert_array_equal(ttrain | tval, fill > 0)
    if (fill >= length0).sum() > 1:
        assert not (ttrain & tval).any()
    assert tlogs["elite_scores"] == jlogs["elite_scores"] == [0.25, 0.5]
    assert tlogs["val_loss"] == jlogs["val_loss"]


def test_update_surrogates_refuses_a_replay_without_windows(controllers):
    jctl, tctl, _ = controllers
    fill = np.zeros(64, np.int32)
    fill[:3] = [1, 2, 4]  # no row reaches tau + 3
    jctl.replay = jctl.replay.replace(fill=jnp.asarray(fill))
    tctl.replay.fill.copy_(torch.as_tensor(fill))
    for ctl in (jctl, tctl):
        ctl.iteration = 0
        with pytest.raises(ValueError, match="no episode long enough for a length-5"):
            ctl.update_surrogates()


def test_config_json_round_trips(tmp_path):
    """The run's ``config.json`` holds the options a resume is started with."""
    ctl = _torch_controller(tmp_path / "t")
    ctl.logger.finish()
    cfg = json.load(open(tmp_path / "t" / "config.json"))
    assert cfg["checkpoint_freq"] == 0 and cfg["resume"] is False
    assert cfg["logging_freq"] == 0 and cfg["profile_dir"] is None
