"""The lock-step ensemble fit (``SurrogateTrainer.fit_ensemble``) on the CPU:
fed a fixed table of batches it equals one one-member ``fit`` per member
(float64 at 1e-9), under a patience stop with an lr ladder and under a
``max_steps`` stop (the cases of ``tests/test_trainer.py:307-359``); under a
``max_steps`` stop its trajectory equals the JAX package's ``fit_ensemble``
on the same replay, and a truncated epoch's val loss is kept out as there;
the ``--sequential_member_training`` record carries the last member's fit
logs, as the JAX package's does; a snapshot restores across the routes; and
the waterfall reads each route's fit timers."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.data import replay as JR
from pdecontrol_tpu.envs.transforms import Identity as JIdentity
from pdecontrol_tpu.envs.transforms import SampleTransform as JSampleTransform
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.train import trainer as JTrn
from pdecontrol_tpu.train.losses import mse_loss as j_mse
from pdecontrol_tpu.train.schedulers import ConstantLengthScheduler as JConstant
from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.envs import transforms as TT
from pdecontrol_tpu_torch.models import factories as TF
from pdecontrol_tpu_torch.models.surrogate import stack_parameters
from pdecontrol_tpu_torch.train import trainer as TTrn
from pdecontrol_tpu_torch.train.losses import make_loss
from pdecontrol_tpu_torch.train.schedulers import ConstantLengthScheduler
from pdecontrol_tpu_torch.utils import checkpoint as C
from pdecontrol_tpu_torch.utils import waterfall

from .test_torch_checkpoint import _controller, _learn

N, M, B, K = 16, 3, 4, 3
# 4 train rows and 2 val rows of 16 steps: 3 windows of length 2 + 3 per
# train row, so 3 batches of 4 per epoch.
FILL = np.array([16, 16, 16, 16, 16, 16, 0, 0], np.int32)
TRAIN = np.array([1, 1, 1, 1, 0, 0, 0, 0], bool)
NB = 3
CASES = {
    "patience": dict(tau=2, tbtt=4, lr=2e-3, lr_gamma=0.7, step_size=2, batch_size=B,
                     patience=1, max_epochs=12),
    "max_steps": dict(tau=2, tbtt=4, lr=2e-3, batch_size=B, patience=50, max_epochs=12,
                      min_steps=4, max_steps=7),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replay(dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    rep = R.create(len(FILL), 16, 2, (1, N), (1, N), dtype)
    rep.obs_seq.copy_(torch.as_tensor(rng.normal(size=tuple(rep.obs_seq.shape))))
    rep.actions.copy_(torch.as_tensor(rng.uniform(-1, 1, tuple(rep.actions.shape))))
    rep.fill.copy_(torch.as_tensor(FILL))
    return rep


def _transforms():
    rng = np.random.default_rng(1)
    und = TT.Normalize.create((1, 1, N), aggregate=True, batched=True, dtype=torch.float64)
    und = und.update(torch.as_tensor(rng.normal(0.3, 2.0, (5, 1, N))))
    scale = TT.Scale.create((1, 1, N), aggregate=True, batched=True, dtype=torch.float64)
    scale = scale.update(torch.as_tensor(rng.normal(0.0, 1.5, (6, 1, 1, N))))
    return und, TT.SampleTransform(otransf=scale)


def _members(seed=0):
    torch.manual_seed(seed)
    return [TF.make("KSAutoRegConvolutionalLSTM", delta=0.25, N=N).double() for _ in range(M)]


def _table(seed, rows):
    rng = np.random.default_rng(seed)
    return [tuple(torch.as_tensor(x) for x in (rng.normal(size=(M, B, 2 + K, 1, N)),
                                                rng.uniform(-1, 1, (M, B, 2 + K, 1, N))))
            for _ in range(rows)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_fit_equals_one_fit_per_member(case):
    """Both fits draw from one table: lock-step step j gives member i the
    batch ``train[j][:, i]``, which is member i's own fit's j-th batch (a
    member that stopped never takes a step again), and epoch e's val batch
    is ``val[e][:, i]`` in both."""
    cfg = TTrn.TrainConfig(**CASES[case])
    loss = make_loss("MSELoss", {})
    und, stransf = _transforms()
    rep = _replay()
    train_mask = torch.as_tensor(TRAIN)
    val_mask = torch.as_tensor(~TRAIN & (FILL > 0))
    train, val = _table(2, 12 * NB), _table(3, 12)
    curriculum = ConstantLengthScheduler(length=K)
    modules = _members()
    init = [p.detach().clone() for m in modules for p in m.parameters()]

    lockstep = TTrn.SurrogateTrainer(loss, cfg)
    drawn = {"train": 0, "val": 0}

    def draw_members(replay, generator, m, length, mask, stransf_):
        kind = "val" if mask is lockstep._inputs.val_mask else "train"
        out = (train if kind == "train" else val)[drawn[kind]]
        drawn[kind] += 1
        return out

    lockstep._draw_members = draw_members
    state = lockstep.init_members(modules, stack_parameters(modules))
    state, val_losses, logs = lockstep.fit_ensemble(
        state, rep, train_mask, val_mask, und, stransf, curriculum, 0, None)
    assert {"t_fit_prep", "t_fit_dispatch", "t_fit_ready"} <= set(logs)

    # One fit per member, from the same initial parameters.
    single = TTrn.SurrogateTrainer(loss, cfg)
    real_val, fits = single.val_step, []
    for i in range(M):
        member = _members()[i]
        with torch.no_grad():
            for p, q in zip(member.parameters(), init[i * len(init) // M:]):
                p.copy_(q)
        own = {"train": 0, "val": 0, "vals": []}

        def draw(replay, generator, length, mask, stransf_, i=i, own=own):
            # The fit draws through its own copies of the masks.
            kind = "val" if mask is single._one_inputs.val_mask else "train"
            out = (train if kind == "train" else val)[own[kind]]
            own[kind] += 1
            return out[0][i], out[1][i]

        def val_step(*args, own=own, **kwargs):
            out = real_val(*args, **kwargs)
            own["vals"].append(float(out["val_loss"]))
            return out

        single._draw, single.val_step = draw, val_step
        st, vl, mlogs = single.fit(single.init(member), rep, train_mask, val_mask, und,
                                   stransf, curriculum, 0, None)
        fits.append((st, mlogs, own))

    steps = [mlogs["steps"] for _, mlogs, _ in fits]
    assert state.global_step.tolist() == state.count.tolist() == steps
    assert logs["steps"] == max(steps)
    assert logs["epochs"] == max(mlogs["epochs"] for _, mlogs, _ in fits)
    if case == "patience":
        assert len(set(steps)) > 1  # the members stopped at different epochs
    else:
        assert steps == [7] * M and logs["epochs"] == 3
    for i, (st, mlogs, own) in enumerate(fits):
        np.testing.assert_allclose(state.params[i].numpy(), st.params[0].numpy(),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(state.exp_avg[i].numpy(), st.exp_avg[0].numpy(),
                                   rtol=1e-9, atol=1e-15)
        # A truncated epoch's val loss (max_steps 7 = 3 + 3 + 1) is kept out
        # of the lock-step score, as in the JAX package; the one-member fit
        # returns it.
        truncated = cfg.max_steps and mlogs["steps"] % NB
        want = own["vals"][-2] if truncated else own["vals"][-1]
        np.testing.assert_allclose(val_losses[i], want, rtol=1e-9)


@pytest.mark.parametrize("max_steps", [7, 2])
def test_max_steps_trajectory_matches_jax_fit_ensemble(max_steps):
    """Under a ``max_steps`` stop the trajectory does not depend on the
    draws: steps, epochs, curriculum K and lr equal the JAX package's
    ``fit_ensemble`` (its whole-fit program) on the same replay.  With
    ``max_steps`` under one epoch's 3 batches, the first epoch is truncated
    and both sides' val losses stay NaN."""
    cfg = CASES["max_steps"]
    jm = JF.make("KSAutoRegFullyConnectedLSTM", delta=0.25, N=N)
    jtr = JTrn.SurrogateTrainer(jm, j_mse, JTrn.TrainConfig(**cfg))
    # float32, as the JAX package's whole-fit program carries its losses.
    jrep = JR.create(len(FILL), 16, 2, (1, N), (1, N), dtype=jnp.float32)
    port = _replay()
    jrep = jrep.replace(obs_seq=jnp.asarray(port.obs_seq.numpy(), jnp.float32),
                        actions=jnp.asarray(port.actions.numpy(), jnp.float32),
                        fill=jnp.asarray(FILL))
    x = jnp.zeros((1, 2, 1, N), jnp.float32)
    jstates = [jtr.init(jax.random.PRNGKey(i), x, x) for i in range(M)]
    mask = jnp.asarray(FILL > 0)
    _, jvl, jlogs = jtr.fit_ensemble(jstates, jrep, mask, mask, JIdentity(),
                                     JSampleTransform(), JConstant(length=K), iteration=0,
                                     key=jax.random.PRNGKey(5), max_steps=max_steps)
    assert "t_fit_ready" in jlogs

    torch.manual_seed(0)
    modules = [TF.make("KSAutoRegFullyConnectedLSTM", delta=0.25, N=N).double()
               for _ in range(M)]
    ttr = TTrn.SurrogateTrainer(make_loss("MSELoss", {}), TTrn.TrainConfig(**cfg))
    tmask = torch.as_tensor(FILL > 0)
    state = ttr.init_members(modules, stack_parameters(modules))
    _, tvl, tlogs = ttr.fit_ensemble(state, port, tmask, tmask, TT.Identity(),
                                     TT.SampleTransform(), ConstantLengthScheduler(length=K),
                                     0, torch.Generator().manual_seed(5),
                                     max_steps=max_steps)
    for k in ("steps", "epochs", "curriculum_K", "lr"):
        assert tlogs[k] == jlogs[k], k
    assert state.global_step.tolist() == [max_steps] * M
    if max_steps < NB:
        assert np.isnan(np.asarray(jvl)).all() and np.isnan(tvl).all()
        assert math.isnan(jlogs["val_loss"]) and math.isnan(tlogs["val_loss"])
    else:
        assert np.isfinite(np.asarray(jvl)).all() and np.isfinite(tvl).all()


def _warm(ctl):
    """The warm-up and one collect step: every row holds a window."""
    ctl.collect(4, random=True)
    ctl.collect(1)
    ctl.update_delta_transform()


def test_sequential_record_carries_the_last_members_fit_logs(tmp_path):
    """``--sequential_member_training``: the record's fit fields are member
    M-1's (``pdecontrol_tpu/mbrl/controller.py:617,636``), the elite scores
    are every member's own, and the clocks cover all the members."""
    ctl = _controller(tmp_path / "run", "--sequential_member_training")
    ctl.logger.finish()
    _warm(ctl)
    real, seen = ctl.trainer.fit, []

    def fit(state, *args, **kwargs):
        out = real(state, *args, **kwargs)
        seen.append((out[0], out[1], dict(out[2])))  # the caller adds to the logs
        return out

    ctl.trainer.fit = fit
    rec = ctl.update_surrogates()
    assert len(seen) == ctl.fit_state.num_members == 2
    last = seen[-1][2]
    for k in ("val_loss", "val_delta_loss", "epochs", "steps", "train_loss", "lr",
              "curriculum_K"):
        assert rec[k] == last[k], k
    assert rec["elite_scores"] == [vl for _, vl, _ in seen]
    for k in ("t_fit_train", "t_fit_val"):
        assert math.isclose(rec[k], sum(logs[k] for _, _, logs in seen), abs_tol=2e-4)
    assert "t_fit_total" in rec and not {"t_fit_prep", "t_fit_ready"} & set(rec)


@pytest.mark.parametrize("first, then", [
    ((), ("--sequential_member_training",)),
    (("--sequential_member_training",), ()),
], ids=["lockstep_to_sequential", "sequential_to_lockstep"])
def test_snapshot_restores_across_the_fit_routes(tmp_path, first, then):
    """A snapshot written under one route restores under the other with the
    same parameters, Adam moments and counts; each member's entry is a
    ``torch.optim.Adam`` state_dict that Adam itself loads."""
    ctl = _learn(tmp_path / "run", "--total_timesteps", "12", "--checkpoint_freq", "2",
                 *first)
    back = _controller(tmp_path / "run", "--resume", *then)
    back.logger.finish()
    assert back.restored
    for k in ("params", "exp_avg", "exp_avg_sq", "count", "global_step"):
        assert torch.equal(getattr(back.fit_state, k), getattr(ctl.fit_state, k)), k
    assert int(ctl.fit_state.count.min()) > 0
    saved = C.controller_state(ctl)["member_states"]
    for member, entry in zip(back.ensemble.members, saved):
        opt = torch.optim.Adam(member.parameters())
        opt.load_state_dict(entry["optimizer"])
        for j, p in enumerate(member.parameters()):
            assert torch.equal(opt.state[p]["exp_avg"], entry["optimizer"]["state"][j]["exp_avg"])
        assert entry["global_step"] == int(entry["optimizer"]["state"][0]["step"])


@pytest.mark.parametrize("route, fields", [
    ("default", {"t_fit_prep": 0.1, "t_fit_dispatch": 0.5, "t_fit_ready": 0.3}),
    ("--no_fuse_fit", {"t_fit_prep": 0.1, "t_fit_dispatch": 0.6, "t_fit_val": 0.2}),
    ("--sequential_member_training", {"t_fit_train": 0.9, "t_fit_val": 0.3}),
])
def test_waterfall_reads_each_routes_fit_timers(tmp_path, route, fields):
    fit = sum(fields.values())
    records = [
        {"iteration": 0, "time": 3.0, "t_warmup_collect": 1.0, "t_warmup_eval": 0.5,
         "t_collect": 0.1, "t_surrogate": fit + 0.4, "t_imagine": 0.3, "t_policy": 0.2,
         "t_pull": 0.0, "t_delta": 0.05, "t_split": 0.05, "t_post": 0.1,
         "t_fit_total": fit + 0.2, **fields},
        {"iteration": 1, "time": 3.5, "t_dispatch": 0.01, "t_ready": 0.4},
    ]
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    out = waterfall.analyze(str(path))["retrain"]
    assert set(fields) <= set(out["surrogate_sub"])
    assert out["fit_internal_residual_s"] == 0.2
    assert out["surrogate_residual_s"] == 0.2
