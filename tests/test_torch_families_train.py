"""Port parity of the four other surrogate families under training: value and
gradient of the training loss of each family under each re-encode schedule,
and the trainer's decoded loss and one Adam step for the LATENT modules,
against the JAX package in float64 at 1e-9 (the forward rollouts are in
``tests/test_torch_families.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.train import trainer as JTrn
from pdecontrol_tpu.train.losses import mse_loss as j_mse
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.models import surrogate as TS
from pdecontrol_tpu_torch.train import trainer as TTrn
from pdecontrol_tpu_torch.train.losses import make_loss

from .test_torch_families import (CASES, DELTA, FAMILIES, N, _case, _close, _f64,
                                  _one_thread, _pair)  # noqa: F401


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("factory", FAMILIES)
def test_family_training_loss_gradient_matches_flax(factory, case):
    """Value and gradient of the mean training loss (on the deltas for an
    AUTOREG family, on the decoded states for a LATENT one) under each
    re-encode schedule: both detach semantics must agree."""
    jm, params, tm, _, actions, jund, tund = _pair(factory, seed=1)
    rng = np.random.default_rng(9)
    states = rng.normal(size=(3, actions.shape[1], 1, N))
    tau = 2
    hidden, reencode = _case(tm, case, actions.shape[1])

    def jloss(p):
        r = jm.apply({"params": p}, jnp.asarray(states[:, :tau]), jnp.asarray(actions),
                     dscaling=jund.inv, reencode=reencode,
                     hidden=None if hidden is None else tuple(jnp.asarray(h)
                                                              for h in hidden))
        if jm.mode == "autoreg":
            target = jund.apply(jnp.diff(jnp.asarray(states), axis=1) / DELTA)
            return jnp.mean(j_mse(r.deltas[:, :-1], target))
        decoded = jnp.concatenate([jnp.asarray(states[:, :1]), r.outputs[:, :-1]], axis=1)
        return jnp.mean(j_mse(decoded, jnp.asarray(states)))

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(params)
    ts = torch.as_tensor(states)
    r = tm.rollout(ts[:, :tau], torch.as_tensor(actions), dscaling=tund.inv,
                   reencode=reencode,
                   hidden=None if hidden is None else tuple(torch.as_tensor(h)
                                                            for h in hidden))
    if tm.mode == TS.AUTOREG:
        tval = torch.mean((r.deltas[:, :-1] - tund.apply(torch.diff(ts, dim=1) / DELTA)) ** 2)
    else:
        tval = torch.mean((torch.cat([ts[:, :1], r.outputs[:, :-1]], dim=1) - ts) ** 2)
    tval.backward()
    _close(tval, jval)
    expect = convert.state_dict(_f64(jgrad))
    grads = dict(tm.named_parameters())
    assert set(expect) == set(grads)
    for name, g in expect.items():
        scale = float(np.abs(g.numpy()).max()) + 1e-30
        got = grads[name].grad
        got = torch.zeros_like(grads[name]) if got is None else got
        _close(got, g.numpy(), rtol=1e-9, atol=1e-10 * scale)


@pytest.mark.parametrize("factory", ["KSLatentConvolutionalLSTM", "KSLatentLSTM"])
def test_decoded_loss_and_train_step_match_jax(factory):
    """The trainer's loss for a LATENT module is on the decoded states
    ``[states[:, :1], outputs[:, :-1]]`` against ``states`` (JAX ``_losses``),
    and one Adam step on it lands on the same parameters."""
    jm, params, tm, _, _, jund, tund = _pair(factory, seed=3)
    rng = np.random.default_rng(8)
    states = rng.normal(size=(4, 7, 1, N))
    actions = rng.uniform(-1, 1, (4, 7, 1, N))
    cfg = dict(tau=2, tbtt=3, lr=1e-3)
    jtr = JTrn.SurrogateTrainer(jm, j_mse, JTrn.TrainConfig(**cfg))
    assert jtr.mode == "decoded"
    jelems, _ = jax.jit(jtr._losses)(params, jnp.asarray(states), jnp.asarray(actions), jund)
    ttr = TTrn.SurrogateTrainer(make_loss("MSELoss", {}), TTrn.TrainConfig(**cfg))
    telems, _ = ttr._losses(tm, torch.as_tensor(states), torch.as_tensor(actions), tund)
    assert telems.shape == (4, 7, 1, N)
    _close(telems, jelems)

    jstate = jtr.init(None, None, None, params=params)
    jstate, jmet = jax.jit(jtr.train_step)(jstate, jnp.asarray(states),
                                           jnp.asarray(actions), jund, jnp.asarray(1e-3))
    tstate = ttr.init(tm)
    tstate, tmet = ttr.train_step(tstate, torch.as_tensor(states), torch.as_tensor(actions),
                                  tund, 1e-3)
    for key in ("train_loss", "hstep_loss", "mean_delta_output", "std_delta_output"):
        _close(tmet[key], jmet[key])
    expect = convert.state_dict(_f64(jstate.params))
    for name, p in tm.named_parameters():
        _close(p, expect[name].numpy(), rtol=1e-9, atol=1e-12)
