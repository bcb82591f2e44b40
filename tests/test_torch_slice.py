"""The port's main path as a whole: one deterministic chain against the JAX
package (policy action -> env step -> world-model step and its recomputed
reward, from the same env state, transforms and converted weights), and a
tiny ``learn()`` on the CPU through the port's CLI entry point."""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.data.types import Sample as JSample
from pdecontrol_tpu.envs import kuramoto as jenv
from pdecontrol_tpu.mbrl.transform_sets import ControllerTransforms as JCT
from pdecontrol_tpu.mbrl.world import WorldModel as JWorld
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.models.surrogate import EnsembleState as JEns
from pdecontrol_tpu.sac.sac import SAC as JSAC
from pdecontrol_tpu.sac.sac import SACConfig as JConfig
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.data.types import Sample
from pdecontrol_tpu_torch.envs import kuramoto as tenv
from pdecontrol_tpu_torch.mbrl import script
from pdecontrol_tpu_torch.mbrl.transform_sets import ControllerTransforms
from pdecontrol_tpu_torch.mbrl.world import WorldModel
from pdecontrol_tpu_torch.models import factories as TF
from pdecontrol_tpu_torch.models.surrogate import init_ensemble
from pdecontrol_tpu_torch.parallel.dryrun import launch
from pdecontrol_tpu_torch.sac.sac import SAC, SACConfig

N, B, TAU = 16, 4, 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, rtol=3e-5, atol=3e-6):
    # tests/test_env_solvers.py tolerance: float32 through the whole chain.
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("solver", ["xla", "pallas"])
def test_deterministic_chain_matches_jax(solver):
    rng = np.random.default_rng(0)
    f32 = np.float32
    je = jenv.KuramotoSivashinsky.create(n=N, cfg_steps=25, dtype=jnp.float32)
    te = tenv.KuramotoSivashinsky.create(n=N, cfg_steps=25, solver=solver)

    # Transforms with the same running statistics.
    jtr, ttr = JCT.create(je, dtype=jnp.float32), ControllerTransforms.create(te)
    seen = rng.uniform(-2, 2, (6, 1, N)).astype(f32)
    deltas = rng.normal(0.1, 1.5, (5, 1, N)).astype(f32)
    jtr = jtr.replace(oscaling=jtr.oscaling.update(jnp.asarray(seen)),
                      undscaling=jtr.undscaling.update(jnp.asarray(deltas)))
    ttr = ttr.replace(oscaling=ttr.oscaling.update(torch.as_tensor(seen)),
                      undscaling=ttr.undscaling.update(torch.as_tensor(deltas)))

    # The policy's deterministic action.
    jsac = JSAC((1, N), (1, 4), JConfig(hidden=32))
    jst = jsac.init(jax.random.PRNGKey(1))
    tsac = SAC((1, N), (1, 4), SACConfig(hidden=32))
    tst = tsac.init()
    tst.policy.load_state_dict(convert.state_dict(
        jax.tree.map(np.asarray, jst.policy_params)))
    u = rng.uniform(-1.5, 1.5, (B, N)).astype(f32)
    jobs, tobs = jnp.asarray(u)[:, None], torch.as_tensor(u)[:, None]
    ja = jsac.select_action(jst, jtr.raw_to_agent_obs(jobs), jax.random.PRNGKey(2),
                            deterministic=True)
    ta = tsac.select_action(tst, ttr.raw_to_agent_obs(tobs), deterministic=True)
    _close(ta, ja)

    # One env step.
    jea, tea = jtr.agent_to_env_action(ja), ttr.agent_to_env_action(ta)
    steps = np.zeros(B, np.int32)
    _, jout = je.step(jenv.EnvState(u=jnp.asarray(u), step=jnp.asarray(steps),
                                    key=jax.random.PRNGKey(0)), jea)
    _, tout = te.step(tenv.EnvState(u=torch.as_tensor(u), step=torch.as_tensor(steps)), tea)
    _close(tout.obs, jout.obs)
    _close(tout.reward, jout.reward)

    # The world model: a teacher-forced warmup, then one imagined step on
    # the same action; two identical members make the elite draw moot.
    jm = JF.make("KSAutoRegConvolutionalLSTM", delta=je.delta, N=N)
    window = rng.uniform(-1.5, 1.5, (B, TAU, 1, N)).astype(f32)
    wacts = rng.uniform(-1, 1, (B, TAU, 1, 4)).astype(f32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(window),
                              jnp.asarray(window))["params"]
    jens = JEns(params=jax.tree.map(lambda p: jnp.stack([p, p]), params),
                elite_mask=jnp.ones((2,), bool), num_elites=2)
    tens = init_ensemble(lambda: TF.make("KSAutoRegConvolutionalLSTM", delta=te.delta, N=N),
                         2)
    for member in tens.members:
        member.load_state_dict(convert.state_dict(
            jax.tree.map(np.asarray, params)), strict=True)

    def batch(S, tr, xp):
        return S(obs=tr.raw_to_world_obs(xp(window)),
                 actions=tr.env_action_to_world(xp(wacts)),
                 steps=xp(np.tile(np.arange(TAU, dtype=np.int32), (B, 1))))

    jworld = JWorld(jm, B, je.max_episode_steps, je.reward_fn, TAU)
    tworld = WorldModel(B, te.max_episode_steps, te.reward_fn, TAU)

    @jax.jit
    def jax_world(ens, warm, tr, ea):
        state = jworld.reset_from_batch(jax.random.PRNGKey(4), ens, warm, tr)
        return state.obs, jworld.advance(jax.random.PRNGKey(5), state, ens,
                                         tr.env_action_to_world(ea), tr)

    jwarm, (jstep, jrew) = jax_world(jens, batch(JSample, jtr, jnp.asarray), jtr, jea)
    tstate = tworld.reset_from_batch(None, tens, batch(Sample, ttr, torch.as_tensor), ttr)
    _close(tstate.obs, jwarm)
    tstep, trew = tworld.advance(None, tstate, tens, ttr.env_action_to_world(tea), ttr)
    _close(tstep.obs, jstep.obs)
    _close(trew, jrew)
    np.testing.assert_array_equal(tstep.timesteps.numpy(), np.asarray(jstep.timesteps))


SMOKE_ARGS = [
    "--platform", "cpu",
    # .claude/skills/verify/SKILL.md section 3, with the reset transient cut
    # to 0.5 time units (the port has no compiled scan on the CPU).
    "--env_config", json.dumps({"n": 16, "cfg_steps": 5, "t_max": 0.04,
                                "transient_time": 0.5}),
    "--num_envs", "2", "--total_timesteps", "24", "--learning_starts", "8",
    "--pool_size", "8", "--surrogate_train_freq", "8",
    "--policy_train_steps_per_sample", "1", "--model_rollouts_per_sample", "2",
    "--model_rollouts_batch_size", "4", "--num_dynamics_models", "2",
    "--policy_batch_size", "8", "--agent_eval_freq", "4", "--num_eval_episodes", "2",
    "--surrogate_eval_horizon", "4", "--solver", "pallas",
    "--rollout_length_schedule", json.dumps({"scheduler": "ConstantLengthScheduler",
                                             "length": 2}),
    "--training", json.dumps({"tau": 2, "initial": {"tbtt": 4, "patience": 2,
                                                    "batch_size": 4},
                              "iterations": {"tbtt": 4, "patience": 1, "batch_size": 4}}),
    "--trainer", json.dumps({"initial": {"min_steps": 2, "max_steps": 6},
                             "iterations": {"min_steps": 1, "max_steps": 3}}),
    "--curriculum", json.dumps({"scheduler": "ConstantLengthScheduler", "length": 3}),
]


def _without(args, flag):
    """``args`` with ``flag`` and its value taken out."""
    i = args.index(flag)
    return args[:i] + args[i + 2:]


def test_learn_smoke_through_cli(tmp_path):
    run_dir = str(tmp_path / "run")
    assert script.main(SMOKE_ARGS + ["--run_dir", run_dir]) == 0
    records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    iters = [r for r in records if "iteration" in r]
    assert [r["iteration"] for r in iters] == list(range(8))  # (24 - 8) / 2
    assert sum("num_ensemble_updates" in r for r in records) == 2
    for key in ("train_loss", "val_loss", "sac_qf_loss", "sac_policy_loss",
                "eval_return_mean", "collect_reward_mean", "imagined_reward_mean",
                "surrogate_open_loop_mse", "reward_model_error"):
        vals = [r[key] for r in records if key in r]
        assert vals and all(math.isfinite(v) for v in vals), key
    # The default route: the retrain iterations (0 and 4) run their phases
    # eagerly; every other one is dispatched as one body and its record
    # committed when the next iteration has been dispatched.
    for r in iters:
        fused = r["iteration"] % 4 != 0
        keys = ("t_dispatch", "t_ready") if fused else ("t_collect", "t_imagine", "t_policy")
        for key in keys + ("env_steps_per_sec",):
            assert key in r, (r["iteration"], key)
    assert iters[-1]["num_steps_sampled"] == 22
    assert json.load(open(os.path.join(run_dir, "config.json")))["env_config"]["solver"] \
        == "pallas"


def test_learn_smoke_through_cli_pallas_packed(tmp_path, monkeypatch):
    """``--solver pallas_packed`` at bf16_3x: ``learn()`` runs through the
    limb kernel's wrapper (its plain version on the CPU)."""
    from pdecontrol_tpu_torch.ops import pallas_ks_packed

    precisions = []
    real = pallas_ks_packed.ks_control_period_packed

    def spy(*args):
        precisions.append(args[6])
        return real(*args)

    monkeypatch.setattr(pallas_ks_packed, "ks_control_period_packed", spy)
    run_dir = str(tmp_path / "run")
    env_config = {"n": 16, "cfg_steps": 5, "t_max": 0.04, "transient_time": 0.5,
                  "pallas_precision": "bf16_3x"}
    assert script.main(SMOKE_ARGS + ["--run_dir", run_dir, "--solver", "pallas_packed",
                                     "--env_config", json.dumps(env_config)]) == 0
    assert precisions and set(precisions) == {"bf16_3x"}
    records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["iteration"] for r in records if "iteration" in r] == list(range(8))
    for key in ("train_loss", "sac_qf_loss", "eval_return_mean", "collect_reward_mean"):
        vals = [r[key] for r in records if key in r]
        assert vals and all(math.isfinite(v) for v in vals), key
    cfg = json.load(open(os.path.join(run_dir, "config.json")))["env_config"]
    assert cfg["solver"] == "pallas_packed" and cfg["pallas_precision"] == "bf16_3x"


@pytest.mark.parametrize("flags", [["--wandb"]])
def test_unported_flags_raise(flags, tmp_path):
    """The flags that used to raise here and now run: ``--factory
    KSLatentLSTM``, ``--loss KSPhyPDELoss`` and ``--env_id BurgersEnv-v0``
    are cases of ``tests/test_torch_slice_families.py``; the mesh flags and
    ``--coordinator_address`` are cases of ``test_mesh_flags``."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        script.main(SMOKE_ARGS + ["--run_dir", str(tmp_path)] + flags)


@pytest.mark.parametrize("flags", [
    ["--data_parallel", "2"], ["--model_parallel", "2"],
    ["--data_parallel", "2", "--coordinator_address"],
], ids=["data_parallel", "model_parallel", "coordinator_address"])
def test_mesh_flags(flags, tmp_path):
    """A mesh flag without the processes of its ranks raises a ValueError
    that names the flags which start them; with ``--coordinator_address``
    two rank processes on the CPU run the smoke arguments to exit 0, and
    only rank 0 writes."""
    if "--coordinator_address" not in flags:
        with pytest.raises(ValueError, match="--coordinator_address"):
            script.main(SMOKE_ARGS + ["--run_dir", str(tmp_path)] + flags)
        return
    address = "file://" + str(tmp_path / "rendezvous")
    cmds = [[sys.executable, "-m", "pdecontrol_tpu_torch.mbrl.script", *SMOKE_ARGS,
             *flags, address, "--num_processes", "2", "--process_id", str(i),
             "--run_dir", str(tmp_path / f"run{i}")] for i in range(2)]
    outs = launch(cmds, 120, str(tmp_path), env=dict(os.environ, OMP_NUM_THREADS="1"))
    for i, out in enumerate(outs):
        assert f"[distributed] rank {i} of 2: backend gloo, device cpu" in out
        assert '"K1": 0' in out  # the plain version on the CPU
    records = [json.loads(line) for line in open(tmp_path / "run0" / "metrics.jsonl")]
    assert [r["iteration"] for r in records if "iteration" in r] == list(range(8))
    assert not (tmp_path / "run1").exists()


# The fields of a retrain record on each fit route: the JAX package's
# (``pdecontrol_tpu/mbrl/controller.py:543-636``, ``train/trainer.py``), and
# ``t_fit_total`` on every route.
FIT_COMMON = {"t_fit_total", "steps", "epochs", "curriculum_K", "lr", "train_loss",
              "val_loss", "elite_scores", "t_split", "t_post", "fit_member_steps",
              "fit_masked_member_steps"}
# The lock-step fit's device stamps, on either of its routes.
FIT_STAMPS = {"t_fit_dev_step", "t_fit_dev_val", "t_fit_dev_wait"}
FIT_ROUTE_FIELDS = {
    "lockstep": FIT_COMMON | FIT_STAMPS | {"t_fit_prep", "t_fit_dispatch", "t_fit_ready"},
    "lockstep_eager": FIT_COMMON | FIT_STAMPS | {"t_fit_prep", "t_fit_dispatch", "t_fit_val"},
    "sequential": FIT_COMMON | {"val_delta_loss", "t_fit_train", "t_fit_val"},
}


@pytest.mark.parametrize("flags, iteration_route, fit_route", [
    ([], "fused", "lockstep"),
    (["--no_fuse_iteration"], "eager", "lockstep"),
    (["--no_fuse_fit"], "fused", "lockstep_eager"),
    (["--sequential_member_training"], "fused", "sequential"),
    (["--no_fuse_iteration", "--no_fuse_fit", "--sequential_member_training"], "eager",
     "sequential"),
    (["--no_fuse_iteration", "--no_fuse_fit"], "eager", "lockstep_eager"),
], ids=["default", "no_fuse_iteration", "no_fuse_fit", "sequential", "all_three",
        "no_fuse_iteration_and_fit"])
def test_fusion_flags_are_accepted(tmp_path, flags, iteration_route, fit_route):
    """``--no_fuse_iteration`` selects the eager phases, each timed after a
    device synchronisation; ``--no_fuse_fit`` the lock-step fit run eagerly
    (on the CPU the default runs it eagerly too, but names its pull
    ``t_fit_ready`` as the JAX package's default route does), and
    ``--sequential_member_training`` one fit per member, whose record is
    the last member's.  Each retrain record carries its route's fields."""
    cfg = script.config_from_args(script.build_parser().parse_args(flags))
    assert cfg.fuse_iteration == ("--no_fuse_iteration" not in flags)
    assert cfg.fuse_fit == ("--no_fuse_fit" not in flags)
    assert cfg.vmap_ensemble_training == ("--sequential_member_training" not in flags)
    run_dir = str(tmp_path / "run")
    assert script.main(SMOKE_ARGS + ["--run_dir", run_dir, "--logging_freq", "0",
                                     "--total_timesteps", "16"] + flags) == 0
    records = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["iteration"] for r in records] == list(range(4))
    for r in records[1:]:
        if iteration_route == "eager":
            assert {"t_collect", "t_imagine", "t_policy", "t_pull"} <= set(r), r
            assert not {"t_dispatch", "t_ready", "t_fused"} & set(r), r
        else:
            assert {"t_dispatch", "t_ready"} <= set(r) and "t_collect" not in r, r
    retrain = records[0]
    want = FIT_ROUTE_FIELDS[fit_route]
    assert want <= set(retrain), sorted(want - set(retrain))
    other = set().union(*FIT_ROUTE_FIELDS.values()) - want
    assert not other & set(retrain), sorted(other & set(retrain))
    assert len(retrain["elite_scores"]) == 2
    assert all(math.isfinite(retrain[k]) for k in ("train_loss", "val_loss"))
    # One member at a time masks nothing; in lock-step each of the longest
    # member's steps computes both members.
    if fit_route == "sequential":
        assert retrain["fit_masked_member_steps"] == 0
        # Both members' steps, each from 2 to the initial fit's max_steps, 6.
        assert retrain["steps"] + 2 <= retrain["fit_member_steps"] <= 2 * 6
    else:
        assert retrain["fit_member_steps"] == 2 * retrain["steps"]
