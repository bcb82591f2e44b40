"""The lock-step step of all ensemble members against the JAX package, in
float64 at 1e-9: ``SurrogateTrainer.lockstep_train_step`` against
``jax.vmap(SurrogateTrainer.train_step)`` with the ``jnp.where(active, new,
old)`` merge of its ``one_train`` (``pdecontrol_tpu/train/trainer.py:437-448``,
without the draw), from the same stacked state converted by
``convert.stacked_trainer_state`` and on the same injected batches; and the
validation step over members against the vmapped ``val_step``.  Three
members take three steps, member 1 sitting the second one out, so that the
members' Adam counts differ; with gradient clipping, at a norm that binds
for one member only.  The flagship and a LATENT family here, the
``LSTMCell`` and ``DelayCell`` families in
``tests/test_torch_lockstep_cells.py``; the fits built on this step are in
``tests/test_torch_lockstep_fit.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from pdecontrol_tpu.envs import transforms as JT
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.train import trainer as JTrn
from pdecontrol_tpu.train.losses import mse_loss as j_mse
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.envs import transforms as TT
from pdecontrol_tpu_torch.models import factories as TF
from pdecontrol_tpu_torch.train import trainer as TTrn
from pdecontrol_tpu_torch.train.losses import make_loss

N, DELTA, M, B, T = 16, 0.25, 3, 3, 7
CFG = dict(tau=2, tbtt=3, lr=1e-3)
# The flagship and a LATENT family; the LSTMCell and DelayCell families are
# cases of tests/test_torch_lockstep_cells.py.
FAMILIES = ["KSAutoRegConvolutionalLSTM", "KSLatentLSTM"]
ACTIVE = [[True, True, True], [True, False, True], [True, True, True]]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                                          else t), np.asarray(j), rtol=rtol, atol=atol)


def _adam(opt_state):
    (adam,) = [s for s in opt_state if hasattr(s, "mu")]
    return adam


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _jax_init(factory):
    jm = JF.make(factory, delta=DELTA, N=N)
    x = jnp.zeros((1, 2, 1, N))
    return jm, _np(jax.jit(jm.init)(jax.random.PRNGKey(0), x, x)["params"])


def _jax_stack(factory, seed=0):
    """M members of ``factory``: one flax initialisation moved off by noise
    of its own for each member (so that no bias sits at zero)."""
    jm, params = _jax_init(factory)
    rng = np.random.default_rng(seed)
    return jm, jax.tree.map(
        lambda p: jnp.asarray(p[None] + 0.02 * rng.normal(size=(M,) + p.shape)), params)


def _jax_state(jtr, params):
    """The JAX package's stacked ``TrainerState`` of fresh members."""
    opt_state = jtr.opt.init(params)
    opt_state = tuple(s._replace(count=jnp.zeros((M,), jnp.int32)) if hasattr(s, "mu") else s
                      for s in opt_state)
    return JTrn.TrainerState(params=params, opt_state=opt_state,
                             global_step=jnp.zeros((M,), jnp.int32))


def _batches(seed, steps):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(M, B, T, 1, N)), rng.uniform(-1, 1, (M, B, T, 1, N)))
            for _ in range(steps)]


def _transforms(seed):
    rng = np.random.default_rng(seed)
    und_data = rng.normal(0.3, 2.0, (5, 1, N))
    seen = rng.normal(0.0, 1.5, (6, 1, 1, N))
    jund = JT.Normalize.create((1, 1, N), aggregate=True, batched=True,
                               dtype=jnp.float64).update(jnp.asarray(und_data))
    tund = TT.Normalize.create((1, 1, N), aggregate=True, batched=True,
                               dtype=torch.float64).update(torch.as_tensor(und_data))
    jscale = JT.Scale.create((1, 1, N), aggregate=True, batched=True,
                             dtype=jnp.float64).update(jnp.asarray(seen))
    tscale = TT.Scale.create((1, 1, N), aggregate=True, batched=True,
                             dtype=torch.float64).update(torch.as_tensor(seen))
    return (jund, JT.SampleTransform(otransf=jscale)), (tund, TT.SampleTransform(otransf=tscale))


def _port_state(factory, jstate):
    adam = _adam(jstate.opt_state)
    modules = [TF.make(factory, delta=DELTA, N=N).double() for _ in range(M)]
    return convert.stacked_trainer_state(modules, _np(jstate.params), _np(adam.mu),
                                         _np(adam.nu), np.asarray(adam.count),
                                         np.asarray(jstate.global_step))


def _assert_states_equal(factory, tstate, jstate):
    want = _port_state(factory, jstate)
    for name in ("params", "exp_avg", "exp_avg_sq"):
        got, ref = getattr(tstate, name), getattr(want, name)
        _close(got, ref.numpy(), atol=1e-10 * (float(ref.abs().max()) + 1e-30))
    np.testing.assert_array_equal(tstate.count.numpy(), want.count.numpy())
    np.testing.assert_array_equal(tstate.global_step.numpy(), want.global_step.numpy())


@pytest.mark.parametrize("clip", ["none", "binds_for_one"])
@pytest.mark.parametrize("factory", FAMILIES)
def test_lockstep_step_matches_vmapped_jax_train_step(factory, clip):
    check_lockstep_step(factory, clip)


def check_lockstep_step(factory, clip):
    jm, params = _jax_stack(factory)
    (jund, jstransf), (tund, tstransf) = _transforms(1)
    batches = _batches(2, len(ACTIVE))
    if clip == "none":
        clip_val = 0.0
    else:
        # Between the largest and the second-largest member's gradient norm
        # at the first step: the clip binds for one member only (and for
        # every member, were the norm taken over all of them together).
        scratch = TTrn.SurrogateTrainer(make_loss("MSELoss", {}), TTrn.TrainConfig(**CFG))
        probe = _port_state(factory, _jax_state(JTrn.SurrogateTrainer(
            jm, j_mse, JTrn.TrainConfig(**CFG)), params))

        def loss(p, s, a):
            return torch.mean(scratch._losses(probe.modules[0], s, a, tund, params=p)[0])

        grads = vmap(grad(loss))(probe.stacked_params(), *map(torch.as_tensor, batches[0]))
        norms = torch.sqrt(sum(torch.sum(g.reshape(M, -1) ** 2, dim=1)
                               for g in grads.values())).numpy()
        top, second = np.sort(norms)[::-1][:2]
        clip_val = float(0.5 * (top + second))
        assert (norms > clip_val).sum() == 1 and np.sqrt(np.sum(norms ** 2)) > clip_val
    cfg = dict(CFG, gradient_clip_val=clip_val)
    jtr = JTrn.SurrogateTrainer(jm, j_mse, JTrn.TrainConfig(**cfg))
    jstate = _jax_state(jtr, params)

    def one(state, s, a, active, lr):
        new, metrics = jtr.train_step(state, s, a, jund, lr)
        merged = jax.tree.map(lambda n, o: jnp.where(active, n, o), new, state)
        return merged, metrics["train_loss"]

    jstep = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))
    ttr = TTrn.SurrogateTrainer(make_loss("MSELoss", {}), TTrn.TrainConfig(**cfg))
    tstate = _port_state(factory, jstate)
    lr = torch.tensor(1e-3, dtype=torch.float64)
    for (states, actions), active in zip(batches, ACTIVE):
        jstate, jloss = jstep(jstate, jnp.asarray(states), jnp.asarray(actions),
                              jnp.asarray(active), jnp.asarray(1e-3))
        tloss = ttr.lockstep_train_step(tstate, torch.as_tensor(states),
                                        torch.as_tensor(actions), tund, lr,
                                        torch.as_tensor(active))
        assert tloss.shape == (M,)
        _close(tloss, jloss)
    np.testing.assert_array_equal(tstate.count.numpy(), [3, 2, 3])
    _assert_states_equal(factory, tstate, jstate)
    # The module views see the fit's writes.
    for module, sd in zip(tstate.modules, convert.ensemble_state_dicts(_np(jstate.params))):
        for name, p in module.named_parameters():
            _close(p, sd[name].numpy(), atol=1e-10 * (float(sd[name].abs().max()) + 1e-30))

    # The validation step of every member on its own batch.
    states, actions = _batches(3, 1)[0]
    jval = jax.jit(jax.vmap(lambda p, s, a: jtr.val_step(p, s, a, jund, jstransf)))(
        jstate.params, jnp.asarray(states), jnp.asarray(actions))
    tval = ttr.lockstep_val_step(tstate, torch.as_tensor(states), torch.as_tensor(actions),
                                 tund, tstransf)
    assert set(tval) == set(jval) == {"val_loss", "val_hstep_loss", "val_delta_loss",
                                      "val_scaled_loss"}
    for key in jval:
        assert tval[key].shape == jval[key].shape, key
        _close(tval[key], jval[key])


def test_stacked_state_converts_member_by_member():
    """A JAX stacked state whose members took different numbers of steps:
    each member's parameters and Adam moments come back in its module's
    layout, with its own count and global step."""
    factory = "KSAutoRegConvolutionalLSTM"
    _, params = _jax_stack(factory, seed=4)
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda p: rng.normal(size=p.shape), _np(params))
    nu = jax.tree.map(lambda p: rng.uniform(0, 1, size=p.shape), _np(params))
    count, global_step = np.array([3, 0, 7], np.int32), np.array([5, 0, 9], np.int32)
    modules = [TF.make(factory, delta=DELTA, N=N).double() for _ in range(M)]
    st = convert.stacked_trainer_state(modules, _np(params), mu, nu, count, global_step)
    assert st.params.shape == st.exp_avg.shape == st.exp_avg_sq.shape
    np.testing.assert_array_equal(st.count.numpy(), count)
    np.testing.assert_array_equal(st.global_step.numpy(), global_step)
    for i, (p_sd, mu_sd, nu_sd) in enumerate(zip(*map(convert.ensemble_state_dicts,
                                                       (_np(params), mu, nu)))):
        member = st.member(i)
        assert member.module is modules[i] and member.count.item() == count[i]
        offset = 0
        for name, p in modules[i].named_parameters():
            n = p.numel()
            torch.testing.assert_close(p.detach(), p_sd[name], rtol=0, atol=0)
            assert p.untyped_storage().data_ptr() == st.params.untyped_storage().data_ptr()
            for flat, want in ((member.exp_avg, mu_sd[name]), (member.exp_avg_sq, nu_sd[name]),
                               (member.params, p_sd[name])):
                torch.testing.assert_close(flat[0, offset: offset + n].view(p.shape), want,
                                           rtol=0, atol=0)
            offset += n
        assert offset == st.params.shape[1]
