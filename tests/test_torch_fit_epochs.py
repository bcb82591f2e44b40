"""The one-member ``fit`` on the CPU in the form its CUDA graphs replay: the
learning rate a tensor written once per epoch, the member trained in the
trainer's slot and copied back, and one pull per epoch.  Fed a fixed table
of batches under an lr ladder, it lands on the parameters and val losses of
the JAX package's ``train_step`` and ``val_step`` chained over the same
batches at each epoch's learning rate (float64 at 1e-9), and it leaves the
member's state and the slot's layout as a graph needs them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs.transforms import SampleTransform as JSampleTransform
from pdecontrol_tpu.train import trainer as JTrn
from pdecontrol_tpu.train.losses import mse_loss as j_mse
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.envs import transforms as TT
from pdecontrol_tpu_torch.models.surrogate import stack_parameters
from pdecontrol_tpu_torch.train import trainer as TTrn
from pdecontrol_tpu_torch.train.losses import make_loss
from pdecontrol_tpu_torch.train.schedulers import ConstantLengthScheduler

from .test_torch_families import N, _close, _f64, _one_thread, _pair  # noqa: F401

K, B = 3, 4
# 4 train rows and 2 val rows of 16 steps: 3 windows of length 2 + 3 per
# train row, so 3 batches of 4 per epoch.
FILL = np.array([16, 16, 16, 16, 16, 16, 0, 0], np.int32)
TRAIN = np.array([1, 1, 1, 1, 0, 0, 0, 0], bool)
NB, EPOCHS = 3, 3
CONFIG = dict(tau=2, tbtt=4, lr=2e-3, lr_gamma=0.5, step_size=1, batch_size=B, patience=50,
              max_epochs=EPOCHS)


def _table(seed, rows):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, 2 + K, 1, N)), rng.uniform(-1, 1, (B, 2 + K, 1, N)))
            for _ in range(rows)]


def _fit(tm, tund, members=None):
    """The port's fit of ``tm`` (or of member 1 of a stack of
    ``members``) on the tables; returns the trainer, the state fitted and
    its logs, and the val losses of each epoch."""
    train, val = _table(2, NB * EPOCHS), _table(3, EPOCHS)
    ttr = TTrn.SurrogateTrainer(make_loss("MSELoss", {}), TTrn.TrainConfig(**CONFIG))
    drawn = {"train": 0, "val": 0}
    vals, real_val = [], ttr.val_step

    def draw(replay, generator, length, mask, stransf):
        assert length == 2 + K
        kind = "val" if mask is ttr._one_inputs.val_mask else "train"
        obs, actions = (train if kind == "train" else val)[drawn[kind]]
        drawn[kind] += 1
        return torch.as_tensor(obs), torch.as_tensor(actions)

    def val_step(*args, **kwargs):
        out = real_val(*args, **kwargs)
        vals.append(float(out["val_loss"]))
        return out

    ttr._draw, ttr.val_step = draw, val_step
    rep = R.create(len(FILL), 16, 2, (1, N), (1, N), torch.float64)
    rep.fill.copy_(torch.as_tensor(FILL))
    if members is None:
        state = ttr.init(tm)
    else:
        stack = ttr.init_members(members, stack_parameters(members))
        state = stack.member(1)
    state, _, logs = ttr.fit(state, rep, torch.as_tensor(TRAIN),
                             torch.as_tensor(~TRAIN & (FILL > 0)), tund, TT.SampleTransform(),
                             ConstantLengthScheduler(length=K), 0, None)
    assert drawn == {"train": NB * EPOCHS, "val": EPOCHS}
    return ttr, state, logs, vals


def test_fit_with_a_tensor_learning_rate_matches_jax():
    jm, params, tm, _, _, jund, tund = _pair("KSAutoRegFullyConnectedLSTM", seed=4)
    ttr, state, logs, vals = _fit(tm, tund)

    jtr = JTrn.SurrogateTrainer(jm, j_mse, JTrn.TrainConfig(**CONFIG))
    jstate = jtr.init(None, None, None, params=params)
    train, val = _table(2, NB * EPOCHS), _table(3, EPOCHS)
    jvals, lrs = [], []
    for epoch in range(EPOCHS):
        lr = CONFIG["lr"] * CONFIG["lr_gamma"] ** (epoch // CONFIG["step_size"])
        lrs.append(lr)
        for obs, actions in train[epoch * NB:(epoch + 1) * NB]:
            jstate, jmet = jtr.train_step(jstate, jnp.asarray(obs), jnp.asarray(actions),
                                          jund, jnp.asarray(lr))
        vm = jtr.val_step(jstate.params, jnp.asarray(val[epoch][0]),
                          jnp.asarray(val[epoch][1]), jund, JSampleTransform())
        jvals.append(float(vm["val_loss"]))

    expect = convert.state_dict(_f64(jstate.params))
    for name, p in tm.named_parameters():
        _close(p, expect[name].numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(vals, jvals, rtol=1e-9)
    np.testing.assert_allclose(logs["train_loss"], float(jmet["train_loss"]), rtol=1e-9)
    np.testing.assert_allclose(logs["val_delta_loss"], float(vm["val_delta_loss"]), rtol=1e-9)
    assert logs["val_loss"] == vals[-1] and logs["lr"] == lrs[-1]
    assert (logs["steps"], logs["epochs"]) == (NB * EPOCHS, EPOCHS)
    assert int(state.global_step[0]) == int(state.count[0]) == NB * EPOCHS
    # The last epoch's learning rate, in the tensor a graph reads.
    assert ttr._one_inputs.lr.dtype == torch.float64
    assert float(ttr._one_inputs.lr) == lrs[-1]


def test_fit_trains_a_member_of_a_stack_through_the_slot():
    """Member 1 of a stack of three is copied into the slot, trained there
    and copied back: it equals the same fit of a lone member, its
    neighbours are untouched, and the slot keeps its addresses."""
    _, _, tm, _, _, _, tund = _pair("KSAutoRegFullyConnectedLSTM", seed=4)
    _, _, lone, _, _, _, _ = _pair("KSAutoRegFullyConnectedLSTM", seed=4)
    members = [_pair("KSAutoRegFullyConnectedLSTM", seed=s)[2] for s in (5, 4, 6)]
    before = [[p.detach().clone() for p in m.parameters()] for m in members]
    ttr, state, _, vals = _fit(None, tund, members)
    slot = ttr._slot
    _, lone_state, _, lone_vals = _fit(lone, tund)
    assert vals == lone_vals
    for p, q in zip(members[1].parameters(), lone.parameters()):
        assert torch.equal(p, q)
    for i in (0, 2):
        for p, q in zip(members[i].parameters(), before[i]):
            assert torch.equal(p, q)
    for a, b in zip(state.tensors(), lone_state.tensors()):
        assert torch.equal(a, b)
    assert slot.params.shape == (1, state.params.shape[1])
    assert slot.modules[0] is not members[1]


@pytest.mark.parametrize("max_steps, steps, stop_epochs", [(7, 7, 3), (2, 2, 1)])
def test_fit_stops_at_max_steps_inside_an_epoch(max_steps, steps, stop_epochs):
    """``max_steps`` cuts an epoch short, as the JAX package's fused epoch
    does (its ``nb_eff``): that epoch's validation still runs, and the fit
    stops after it."""
    _, _, tm, _, _, _, tund = _pair("KSAutoRegFullyConnectedLSTM", seed=4)
    ttr = TTrn.SurrogateTrainer(make_loss("MSELoss", {}),
                                TTrn.TrainConfig(**{**CONFIG, "max_steps": max_steps}))
    rep = R.create(len(FILL), 16, 2, (1, N), (1, N), torch.float64)
    rng = np.random.default_rng(0)
    rep.obs_seq.copy_(torch.as_tensor(rng.normal(size=tuple(rep.obs_seq.shape))))
    rep.actions.copy_(torch.as_tensor(rng.uniform(-1, 1, tuple(rep.actions.shape))))
    rep.fill.copy_(torch.as_tensor(FILL))
    state, val_loss, logs = ttr.fit(
        ttr.init(tm), rep, torch.as_tensor(TRAIN), torch.as_tensor(~TRAIN & (FILL > 0)),
        tund, TT.SampleTransform(), ConstantLengthScheduler(length=K), 0,
        torch.Generator().manual_seed(0))
    assert (logs["steps"], logs["epochs"]) == (steps, stop_epochs)
    assert int(state.global_step[0]) == steps
    assert np.isfinite(val_loss) and np.isfinite(logs["train_loss"])
