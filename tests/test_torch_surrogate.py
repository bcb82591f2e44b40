"""Port parity of the surrogate: each block, the fused CNN-LSTM cell, the
whole AUTOREG rollout (forward and gradient), the ensemble and one trainer
step, against the JAX package with parameters carried over by
``pdecontrol_tpu_torch.convert``.  Both sides run in float64 and agree to
1e-9: the point here is the algorithm, not the rounding."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs import transforms as JT
from pdecontrol_tpu.models import blocks as JB
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.models import surrogate as JS
from pdecontrol_tpu.models import transition as JTr
from pdecontrol_tpu.train import trainer as JTrn
from pdecontrol_tpu.train.losses import mse_loss as j_mse
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.envs import transforms as TT
from pdecontrol_tpu_torch.models import blocks as TB
from pdecontrol_tpu_torch.models import factories as TF
from pdecontrol_tpu_torch.models import surrogate as TS
from pdecontrol_tpu_torch.models import transition as TTr
from pdecontrol_tpu_torch.train import trainer as TTrn
from pdecontrol_tpu_torch.train.losses import make_loss

N = 16
DELTA = 0.25


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _load(module, params):
    module.double().load_state_dict(convert.state_dict(_f64(params)), strict=True)
    return module


def _close(t, j, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _nwc(x):
    return jnp.asarray(np.swapaxes(x, -1, -2))


@pytest.mark.parametrize("kind", ["residual", "deconv", "conv7", "conv5_identity"])
def test_blocks_match_flax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 8))  # [B, C, H]
    if kind == "residual":
        jm = JB.ResidualBlock(features=6, stride=2, layernorm=True)
        tm = TB.ResidualBlock(4, 6, 8, stride=2, layernorm=True)
    elif kind == "deconv":
        jm = JB.DeConvBlock(features=5, stride=2, layernorm=True)
        tm = TB.DeConvBlock(4, 5, 8, stride=2, layernorm=True)
    elif kind == "conv7":
        jm = JB.ConvBlock(features=3, kernel_size=7, layernorm=True)
        tm = TB.ConvBlock(4, 3, 8, kernel_size=7, layernorm=True)
    else:
        jm = JB.ConvBlock(features=1, kernel_size=5, activation=lambda v: v)
        tm = TB.ConvBlock(4, 1, 8, kernel_size=5, activation=TB.identity)
    params = _f64(jax.jit(jm.init)(jax.random.PRNGKey(1), _nwc(x))["params"])
    # Randomise the LayerNorm scale/bias too, so the layout is exercised.
    params = jax.tree.map(lambda p: p + 0.1 * rng.normal(size=p.shape), params)
    y = jax.jit(jm.apply)({"params": params}, _nwc(x))
    _load(tm, params)
    _close(tm(torch.as_tensor(x)), np.swapaxes(np.asarray(y), -1, -2))


@pytest.mark.parametrize("tf", [True, False])
def test_cnn_lstm_cell_matches_flax(tf):
    rng = np.random.default_rng(1)
    b, c, h = 3, 16, 4
    la = rng.normal(size=(b, 4, h))
    ls = rng.normal(size=(b, c, h))
    carry = (rng.normal(size=(b, c, h)), rng.normal(size=(b, c, h)))
    jm = JTr.CNNLSTMCell(schannels=c, ssize=h)
    jcarry = tuple(jnp.asarray(x) for x in carry)
    params = _f64(jax.jit(jm.init)(jax.random.PRNGKey(2), jcarry, jnp.asarray(la),
                                   jnp.asarray(ls), jnp.asarray(True))["params"])
    # Gate order (i, f, c, o) with the output-gate bias initialised to 1.
    np.testing.assert_array_equal(params["wx"]["bias"], np.r_[np.zeros(3 * c), np.ones(c)])
    tm = TTr.CNNLSTMCell(4, schannels=c, ssize=h)
    np.testing.assert_array_equal(tm.wx.bias.detach().numpy(), params["wx"]["bias"])
    _load(tm, params)
    (jh, jc), jout = jm.apply({"params": params}, jcarry, jnp.asarray(la), jnp.asarray(ls),
                              jnp.asarray(tf))
    (th, tc), tout = tm(tuple(torch.as_tensor(x) for x in carry), torch.as_tensor(la),
                        torch.as_tensor(ls), tf)
    _close(th, jh)
    _close(tc, jc)
    _close(tout, jout)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """One set of flax parameters for the whole file (initialised once: the
    surrogate's parameter shapes do not depend on the window lengths)."""
    jm = JF.make("KSAutoRegConvolutionalLSTM", delta=DELTA, N=N)
    x = jnp.zeros((1, 2, 1, N))
    return jm, _f64(jax.jit(jm.init)(jax.random.PRNGKey(0), x, x)["params"])


def _model_pair(seed=0, b=3, tw=2, t=7):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(b, tw, 1, N))
    actions = rng.uniform(-1, 1, (b, t, 1, N))
    jm, params = _jax_params()
    tm = _load(TF.make("KSAutoRegConvolutionalLSTM", delta=DELTA, N=N), params)
    und_data = rng.normal(0.3, 2.0, (5, 1, N))
    jund = JT.Normalize.create((1, 1, N), aggregate=True, batched=True,
                               dtype=jnp.float64).update(jnp.asarray(und_data))
    tund = TT.Normalize.create((1, 1, N), aggregate=True, batched=True,
                               dtype=torch.float64).update(torch.as_tensor(und_data))
    return jm, params, tm, states, actions, jund, tund


def _roll_pair(jm, params, tm, states, actions, jund, tund, reencode, hidden=None):
    apply = jax.jit(lambda p, s, a, d, h: jm.apply({"params": p}, s, a, dscaling=d,
                                                   reencode=reencode, hidden=h))
    jroll = apply(params, jnp.asarray(states), jnp.asarray(actions), jund.inv,
                  None if hidden is None else tuple(jnp.asarray(h) for h in hidden))
    troll = tm.rollout(torch.as_tensor(states), torch.as_tensor(actions), dscaling=tund.inv,
                       reencode=reencode,
                       hidden=None if hidden is None else tuple(torch.as_tensor(h)
                                                                for h in hidden))
    return jroll, troll


@pytest.mark.parametrize("case", ["free_run", "tbptt_mask", "hidden_reencode_all"])
def test_rollout_forward_matches_flax(case):
    jm, params, tm, states, actions, jund, tund = _model_pair()
    hidden, reencode = None, None
    if case == "tbptt_mask":
        reencode = JTrn.tbtt_reencode_mask(actions.shape[1], 3)
        assert reencode.any()
    elif case == "hidden_reencode_all":
        rng = np.random.default_rng(5)
        hidden = (rng.normal(size=(3, 16, N // 4)), rng.normal(size=(3, 16, N // 4)))
        reencode = True
    jroll, troll = _roll_pair(jm, params, tm, states, actions, jund, tund, reencode, hidden)
    for field in ("outputs", "deltas", "inlatents", "outlatents"):
        _close(getattr(troll, field), getattr(jroll, field))
    for th, jh in zip(troll.hidden, jroll.hidden):
        _close(th, jh)


def test_rollout_gradient_matches_flax():
    """Gradient of a fixed projection of the TBPTT-masked rollout: both
    detach semantics (self-forcing at chunk boundaries keeps encoder-weight
    gradients; the plain free-run re-encode does not) must agree."""
    jm, params, tm, states, actions, jund, tund = _model_pair(seed=1)
    reencode = JTrn.tbtt_reencode_mask(actions.shape[1], 3)
    rng = np.random.default_rng(7)
    w_out = rng.normal(size=(3, actions.shape[1], 1, N))
    w_del = rng.normal(size=(3, actions.shape[1], 1, N))

    def jloss(p):
        r = jm.apply({"params": p}, jnp.asarray(states), jnp.asarray(actions),
                     dscaling=jund.inv, reencode=reencode)
        return jnp.sum(r.outputs * w_out) + jnp.sum(r.deltas * w_del)

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(params)
    r = tm.rollout(torch.as_tensor(states), torch.as_tensor(actions), dscaling=tund.inv,
                   reencode=reencode)
    tval = torch.sum(r.outputs * torch.as_tensor(w_out)) + torch.sum(
        r.deltas * torch.as_tensor(w_del))
    tval.backward()
    _close(tval, jval)
    expect = convert.state_dict(_f64(jgrad))
    grads = dict(tm.named_parameters())
    assert set(expect) == set(grads)
    for name, g in expect.items():
        scale = float(np.abs(g.numpy()).max()) + 1e-30
        _close(grads[name].grad, g.numpy(), rtol=1e-9, atol=1e-10 * scale)


def test_ensemble_rollout_and_elites_match_flax():
    rng = np.random.default_rng(2)
    states = rng.normal(size=(4, 2, 1, N))
    actions = rng.uniform(-1, 1, (4, 3, 1, N))
    jm, params = _jax_params()
    # Two distinct members: the shared parameters and a perturbed copy.
    stacked = jax.tree.map(
        lambda p: np.stack([p, p + 0.05 * rng.normal(size=p.shape)]), params)
    jens = JS.EnsembleState(params=stacked, elite_mask=jnp.ones((2,), bool), num_elites=1)
    tens = TS.init_ensemble(lambda: TF.make("KSAutoRegConvolutionalLSTM", delta=DELTA, N=N),
                            2, num_elites=1)
    for member, sd in zip(tens.members, convert.ensemble_state_dicts(stacked)):
        member.double().load_state_dict(sd, strict=True)
    jroll = jax.jit(lambda e, s, a: JS.ensemble_rollout(jm, e, s, a))(
        jens, jnp.asarray(states), jnp.asarray(actions))
    troll = TS.ensemble_rollout(tens, torch.as_tensor(states), torch.as_tensor(actions))
    assert troll.outputs.shape == (2, 4, 3, 1, N)
    _close(troll.outputs, jroll.outputs)
    for th, jh in zip(troll.hidden, jroll.hidden):
        _close(th, jh)
    scores = np.array([0.7, 0.2])
    jens = JS.update_elites(jens, jnp.asarray(scores))
    tens = TS.update_elites(tens, torch.as_tensor(scores))
    np.testing.assert_array_equal(tens.elite_mask.numpy(), np.asarray(jens.elite_mask))
    sel, members = TS.select_elites(torch.Generator().manual_seed(0), tens,
                                    troll.outputs[:, :, -1])
    assert (members == 1).all()
    _close(sel, np.asarray(jroll.outputs)[1, :, -1])


def test_train_and_val_step_match_jax():
    """One Adam step of the TBPTT loss and the free-run val metrics."""
    jm, params, tm, states, _, jund, tund = _model_pair(seed=3, b=4, tw=7, t=7)
    actions = np.random.default_rng(8).uniform(-1, 1, (4, 7, 1, N))
    cfg = dict(tau=2, tbtt=3, lr=1e-3)
    jtr = JTrn.SurrogateTrainer(jm, j_mse, JTrn.TrainConfig(**cfg))
    jstate = jtr.init(None, None, None, params=params)
    jstate, jmet = jax.jit(jtr.train_step)(jstate, jnp.asarray(states),
                                           jnp.asarray(actions), jund, jnp.asarray(1e-3))
    ttr = TTrn.SurrogateTrainer(make_loss("MSELoss", {}), TTrn.TrainConfig(**cfg))
    tstate = ttr.init(tm)
    tstate, tmet = ttr.train_step(tstate, torch.as_tensor(states), torch.as_tensor(actions),
                                  tund, 1e-3)
    assert tstate.global_step == 1
    _close(tmet["train_loss"], jmet["train_loss"])
    _close(tmet["hstep_loss"], jmet["hstep_loss"])
    expect = convert.state_dict(_f64(jstate.params))
    for name, p in tm.named_parameters():
        _close(p, expect[name].numpy(), rtol=1e-9, atol=1e-12)

    jscale = JT.Scale.create((1, 1, N), aggregate=True, batched=True, dtype=jnp.float64)
    jscale = jscale.update(jnp.asarray(states[:, :1]))
    tscale = TT.Scale.create((1, 1, N), aggregate=True, batched=True, dtype=torch.float64)
    tscale = tscale.update(torch.as_tensor(states[:, :1]))
    jv = jax.jit(jtr.val_step)(jstate.params, jnp.asarray(states), jnp.asarray(actions),
                               jund, JT.SampleTransform(otransf=jscale))
    tv = ttr.val_step(tm, torch.as_tensor(states), torch.as_tensor(actions), tund,
                      TT.SampleTransform(otransf=tscale))
    for key in ("val_loss", "val_hstep_loss", "val_delta_loss", "val_scaled_loss"):
        _close(tv[key], jv[key])
