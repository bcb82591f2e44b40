"""Port parity of the four other surrogate families: the fully connected
blocks, ``LSTMCell`` and ``DelayCell`` and the forward rollout of each family
(the gradients and the trainer's loss are in
``tests/test_torch_families_train.py``), against the JAX package with parameters carried over by
``pdecontrol_tpu_torch.convert``.  Both sides run in float64 and agree to
1e-9.  The LATENT cases warm up over more than one step, so that the
integrated latent that is not re-anchored on the ground truth shows.  The
windows are six steps long: through the random weights' encode-decode round
trip a last-bit difference grows about fivefold per re-encoded step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs import transforms as JT
from pdecontrol_tpu.models import blocks as JB
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.models import transition as JTr
from pdecontrol_tpu.train import trainer as JTrn
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.envs import transforms as TT
from pdecontrol_tpu_torch.models import blocks as TB
from pdecontrol_tpu_torch.models import factories as TF
from pdecontrol_tpu_torch.models import surrogate as TS
from pdecontrol_tpu_torch.models import transition as TTr

N = 16
DELTA = 0.25
FAMILIES = ["KSLatentConvolutionalLSTM", "KSAutoRegFullyConnectedLSTM", "KSLatentLSTM",
            "KSDelayCNNSurrogateFactory"]
CASES = ["free_run", "tbptt_mask", "hidden_reencode_all"]


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


def _randomised(params, rng, scale=0.1):
    """Zero-initialised biases would hide a misplaced one."""
    return jax.tree.map(lambda p: p + scale * rng.normal(size=p.shape), params)


@pytest.mark.parametrize("kind", ["linear_block", "mlp", "identity"])
def test_fc_blocks_match_flax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 2, 8))
    if kind == "linear_block":
        jm = JB.LinearBlock(3, 5, jax.nn.elu)
        tm = TB.LinearBlock(16, 3, 5, torch.nn.functional.elu)
    elif kind == "mlp":
        jm = JB.MLP(sizes=[(2, 6), (1, 4)], activations=[jax.nn.silu, jnp.tanh])
        tm = TB.MLP(2, 8, sizes=[(2, 6), (1, 4)],
                    activations=[torch.nn.functional.silu, torch.tanh])
        assert (tm.out_channels, tm.out_size) == (1, 4)
    else:
        _close(TB.IdentityModule()(torch.as_tensor(x)),
               JB.IdentityModule().apply({}, jnp.asarray(x)))
        return
    params = _f64(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    params = _randomised(params, rng)
    _load(tm, params)
    _close(tm(torch.as_tensor(x)), jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))


def test_linear_block_initialises_like_flax_dense():
    """LeCun normal (truncated at two standard deviations, variance 1/fan_in)
    and a zero bias."""
    torch.manual_seed(0)
    tm = TB.LinearBlock(400, 20, 20)
    w = tm.linear.weight.detach().numpy()
    assert abs(w.std() - (1 / 400) ** 0.5) < 0.05 * (1 / 400) ** 0.5
    assert np.abs(w).max() <= 2 * (1 / 400) ** 0.5 / 0.87962566103423978 + 1e-7
    assert not tm.linear.bias.detach().numpy().any()


@pytest.mark.parametrize("tf", [True, False], ids=["forced", "free"])
def test_lstm_cell_matches_flax(tf):
    rng = np.random.default_rng(1)
    b, c, h = 3, 2, 4
    la = rng.normal(size=(b, 1, 6))
    ls = rng.normal(size=(b, c, h))
    carry = (rng.normal(size=(b, c * h)), rng.normal(size=(b, c * h)))
    jm = JTr.LSTMCell(schannels=c, ssize=h)
    jcarry = tuple(jnp.asarray(x) for x in carry)
    params = _f64(jax.jit(jm.init)(jax.random.PRNGKey(2), jcarry, jnp.asarray(la),
                                   jnp.asarray(ls), jnp.asarray(True))["params"])
    assert set(params["wh"]) == {"kernel"}  # no bias
    params = _randomised(params, rng)
    tm = _load(TTr.LSTMCell(6, schannels=c, ssize=h), params)
    assert [tuple(z.shape) for z in tm.init_carry(b)] == [(b, c * h)] * 2
    (jh, jc), jout = jm.apply({"params": params}, jcarry, jnp.asarray(la), jnp.asarray(ls),
                              jnp.asarray(tf))
    (th, tc), tout = tm(tuple(torch.as_tensor(x) for x in carry), torch.as_tensor(la),
                        torch.as_tensor(ls), tf)
    assert tout.shape == (b, c, h)
    _close(th, jh)
    _close(tc, jc)
    _close(tout, jout)


def test_delay_cell_matches_flax_over_three_pushes():
    """Three pushes into a delay-3 buffer: the ring order (newest last) and
    the state/action interleaving on the channel axis both show."""
    rng = np.random.default_rng(2)
    b, sc, ac, h, delay = 2, 3, 2, 4, 3
    sizes, jacts = [(4, h), (sc, h)], [jax.nn.elu, jnp.tanh]
    jm = JTr.DelayCell(schannels=sc, ssize=h, achannels=ac, asize=h, delay=delay,
                       fwd=JB.MLP(sizes=sizes, activations=jacts))
    tm = TTr.DelayCell(TB.MLP(delay * (sc + ac), h, sizes=sizes,
                              activations=[torch.nn.functional.elu, torch.tanh]),
                       schannels=sc, ssize=h, achannels=ac, asize=h, delay=delay)
    assert tm.needs_prev_latent and jm.needs_prev_latent
    jcarry = jm.init_carry(b, jnp.float64)
    tcarry = tm.init_carry(b, torch.float64)
    assert [tuple(z.shape) for z in tcarry] == [tuple(z.shape) for z in jcarry]
    la0, ls0 = rng.normal(size=(b, ac, h)), rng.normal(size=(b, sc, h))
    params = _f64(jax.jit(jm.init)(jax.random.PRNGKey(3), jcarry, jnp.asarray(la0),
                                   jnp.asarray(ls0), jnp.asarray(True))["params"])
    params = _randomised(params, rng)
    _load(tm, params)
    japply = jax.jit(jm.apply)
    for step in range(3):
        la, ls = rng.normal(size=(b, ac, h)), rng.normal(size=(b, sc, h))
        tf = step % 2 == 0  # ignored by the cell
        jcarry, jout = japply({"params": params}, jcarry, jnp.asarray(la), jnp.asarray(ls),
                              jnp.asarray(tf))
        tcarry, tout = tm(tcarry, torch.as_tensor(la), torch.as_tensor(ls), tf)
        _close(tout, jout)
        for tc, jc in zip(tcarry, jcarry):
            _close(tc, jc)
    # The newest state sits in the last slot.
    _close(tcarry[0][:, -1], ls)


@functools.lru_cache(maxsize=None)
def _jax_model(factory):
    jm = JF.make(factory, delta=DELTA, N=N)
    x = jnp.zeros((1, 2, 1, N))
    params = _f64(jax.jit(jm.init)(jax.random.PRNGKey(0), x, x)["params"])
    return jm, _randomised(params, np.random.default_rng(11), 0.02)


def _pair(factory, seed=0, b=3, tw=2, t=6):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(b, tw, 1, N))
    actions = rng.uniform(-1, 1, (b, t, 1, N))
    jm, params = _jax_model(factory)
    tm = _load(TF.make(factory, delta=DELTA, N=N), params)
    und_data = rng.normal(0.3, 2.0, (5, 1, N))
    jund = JT.Normalize.create((1, 1, N), aggregate=True, batched=True,
                               dtype=jnp.float64).update(jnp.asarray(und_data))
    tund = TT.Normalize.create((1, 1, N), aggregate=True, batched=True,
                               dtype=torch.float64).update(torch.as_tensor(und_data))
    return jm, params, tm, states, actions, jund, tund


def _case(tm, case, t_total, b=3):
    hidden, reencode = None, None
    if case == "tbptt_mask":
        reencode = JTrn.tbtt_reencode_mask(t_total, 3)
        assert reencode.any()
    elif case == "hidden_reencode_all":
        rng = np.random.default_rng(5)
        hidden = tuple(rng.normal(size=tuple(z.shape)) for z in tm.cell.init_carry(b))
        reencode = True
    return hidden, reencode


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("factory", FAMILIES)
def test_family_rollout_forward_matches_flax(factory, case):
    jm, params, tm, states, actions, jund, tund = _pair(factory)
    assert tm.mode == jm.mode
    hidden, reencode = _case(tm, case, actions.shape[1])
    jroll = jax.jit(lambda p, s, a, d, h: jm.apply({"params": p}, s, a, dscaling=d,
                                                   reencode=reencode, hidden=h))(
        params, jnp.asarray(states), jnp.asarray(actions), jund.inv,
        None if hidden is None else tuple(jnp.asarray(h) for h in hidden))
    troll = tm.rollout(torch.as_tensor(states), torch.as_tensor(actions), dscaling=tund.inv,
                       reencode=reencode,
                       hidden=None if hidden is None else tuple(torch.as_tensor(h)
                                                                for h in hidden))
    for field in ("outputs", "deltas", "inlatents", "outlatents"):
        _close(getattr(troll, field), getattr(jroll, field))
    assert len(troll.hidden) == len(jroll.hidden)
    for th, jh in zip(troll.hidden, jroll.hidden):
        assert th.shape == jh.shape
        _close(th, jh)


def test_latent_warmup_does_not_reanchor_the_integrated_latent():
    """With a warmup of two steps the LATENT output of step 1 still
    integrates from the first state's encoding: the second warmup state is
    forced into the cell's hidden, not into the latent the step starts from."""
    _, _, tm, states, actions, _, tund = _pair("KSLatentConvolutionalLSTM")
    roll = tm.rollout(torch.as_tensor(states), torch.as_tensor(actions), dscaling=tund.inv)
    lat0 = tm.state_encoder(torch.as_tensor(states[:, 0]))
    expect = lat0 + DELTA * roll.outlatents[:, 0] + DELTA * roll.outlatents[:, 1]
    _close(roll.outputs[:, 1], tm.state_decoder(expect).detach().numpy())
    # inlatents report what the cell was handed: the forced ground truth.
    _close(roll.inlatents[:, 1],
           tm.state_encoder(torch.as_tensor(states[:, 1])).detach().numpy())


@pytest.mark.parametrize("factory", FAMILIES)
def test_convert_loads_every_family_strictly(factory):
    _, params = _jax_model(factory)
    tm = TF.make(factory, delta=DELTA, N=N).double()
    sd = convert.state_dict(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)


def test_factory_widths_at_full_size():
    """The factory widths at N = 64 (JAX ``models/factories.py:99-162``)."""
    count = lambda m: sum(p.numel() for p in m.parameters())
    for name in FAMILIES + ["KSAutoRegConvolutionalLSTM"]:
        jm = JF.make(name, delta=DELTA, N=64)
        x = jnp.zeros((1, 2, 1, 64))
        jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x)["params"]
        assert count(TF.make(name, delta=DELTA, N=64)) == sum(
            int(np.prod(p.shape)) for p in jax.tree.leaves(jp)), name
    with pytest.raises(KeyError, match="unknown factory"):
        TF.make("NoSuchFactory", delta=DELTA)
    assert sorted(TF.REGISTRY) == sorted(JF.REGISTRY)


def test_ensemble_rollout_carries_hidden_of_any_rank():
    """``LSTMCell``'s carry is [B, hidden], ``DelayCell``'s [B, delay, C, H]:
    the ensemble stacks and unstacks both."""
    rng = np.random.default_rng(4)
    for factory, shapes in (("KSLatentLSTM", [(2, 3, N // 4)] * 2),
                            ("KSDelayCNNSurrogateFactory",
                             [(2, 3, 3, 8, N // 8), (2, 3, 3, 4, N // 8)])):
        ens = TS.init_ensemble(lambda: TF.make(factory, delta=DELTA, N=N), 2)
        states = torch.as_tensor(rng.normal(size=(3, 2, 1, N)), dtype=torch.float32)
        actions = torch.as_tensor(rng.uniform(-1, 1, (3, 2, 1, N)), dtype=torch.float32)
        with torch.no_grad():
            roll = TS.ensemble_rollout(ens, states, actions)
            assert [tuple(h.shape) for h in roll.hidden] == shapes
            step = TS.ensemble_rollout(ens, roll.outputs[0, :, -1:], actions[:, :1],
                                       hidden=roll.hidden)
            one = ens.members[1].rollout(roll.outputs[0, :, -1:], actions[:, :1],
                                         hidden=tuple(h[1] for h in roll.hidden))
        assert step.outputs.shape == (2, 3, 1, 1, N)
        torch.testing.assert_close(step.outputs[1], one.outputs)


def test_align_actions_matches_jax():
    from pdecontrol_tpu.models.surrogate import align_actions as j_align

    times = np.array([0.0, 0.25, 0.5, 1.0, 1.25])
    np.testing.assert_array_equal(TS.align_actions(times, 0.25), j_align(times, 0.25))
    np.testing.assert_array_equal(TS.align_actions(times[:, None], 0.5), j_align(times, 0.5))
