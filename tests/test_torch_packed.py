"""Kernel K2 (bf16-limb KS control period) of the port against the JAX
package on the CPU: the operator builders, the limb product, the plain
period against the Pallas kernel body, the kernel wrapper's routing, and
the env's ``pallas_packed`` solver.

The JAX package's limb modes compute something other than the TPU on the
CPU: ``_make_dot("bf16_3x")`` passes a float32 ``W`` to a dot that XLA on
the CPU keeps in float32, where the MXU rounds it to bf16, so ``W_lo``
counts twice.  The limb modes are therefore held against the JAX kernel
body with ``_make_dot`` swapped for the TPU arithmetic (every operand
bf16-rounded, float32 accumulation: ``tests/test_pallas_ks.py:119-130``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs import kuramoto as jenv
from pdecontrol_tpu.ops import pallas_ks_packed as P
from pdecontrol_tpu.ops.kuramoto import KSOperators as JOps
from pdecontrol_tpu_torch.envs import kuramoto as tenv
from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed as T
from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

LIMB_MODES = ("bf16", "bf16_3x", "bf16_4x")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(n=64):
    return KSOperators.create(n, 22.0), JOps.create(n, 22.0, dtype=jnp.float32)


def _smooth(rng, b, scale, n=64, modes=8):
    """Smooth rows (attractor states are smooth), max |u| = ``scale``."""
    f = np.fft.rfft(rng.normal(size=(b, n)), axis=-1)
    f[:, modes:] = 0
    u = np.fft.irfft(f, n=n, axis=-1)
    return (u / np.abs(u).max() * scale).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# ----------------------------------------------------------------- operators
@pytest.mark.parametrize("n", [16, 64])
def test_operator_builders_bit_equal_to_jax(n):
    ops, jops = _ops(n)
    for got, want in zip(T.packed_matrices(ops), P.packed_matrices(jops)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(T.packed_linear_separate(ops), P.packed_linear_separate(jops))
    np.testing.assert_array_equal(T.packed_uxx_matrix(ops), P.packed_uxx_matrix(jops))


def test_separate_linear_layout_sums_to_presummed():
    """The limb modes' separate-block operator is the pre-summed one once
    its halves are added (float32 round-off of the same float64 source)."""
    ops, _ = _ops()
    wl_sum, _ = T.packed_matrices(ops)
    wl_sep = T.packed_linear_separate(ops)
    n2 = wl_sum.shape[0]
    np.testing.assert_allclose(wl_sep[:, :n2] + wl_sep[:, n2:], wl_sum,
                               rtol=0, atol=1e-4 * np.abs(wl_sum).max())


def test_unpacked_operators_are_the_diagonal_blocks():
    ops, _ = _ops()
    n = 64
    sep = T.packed_linear_separate(ops)
    w_lin, w_up = T.packed_matrices(ops)
    limb = T.unpacked_operators(ops, "bf16_3x")
    assert limb["lin"].shape == (n, 2 * n)
    np.testing.assert_array_equal(limb["lin"][:, :n], sep[n:, n : 2 * n])
    np.testing.assert_array_equal(limb["lin"][:, n:], sep[n:, 3 * n :])
    np.testing.assert_array_equal(limb["up"][:, :n], w_up[n:, n : 2 * n])
    np.testing.assert_array_equal(limb["up"][:, n:], w_up[n:, 3 * n :])
    np.testing.assert_array_equal(limb["uxx"], T.packed_uxx_matrix(ops)[n:, n:])
    np.testing.assert_array_equal(T.unpacked_operators(ops, "highest")["lin"], w_lin[:n, :n])
    with pytest.raises(ValueError):
        T.unpacked_operators(ops, "bf16_2x")


def test_limb_taps_are_the_limbs_of_the_matrix_entries():
    """The kernel's 52 taps are the bf16 hi/lo limbs of the nonzero entries
    of the limb-mode operators, and the stencils they span are the whole
    matrices (every other entry is zero)."""
    ops, _ = _ops()
    n = 64
    mats = T.unpacked_operators(ops, "bf16_3x")
    taps = T.limb_taps(ops)
    assert taps.shape == (52,) and taps.dtype == np.float32
    blocks = [(mats["lin"][:, :n], range(-3, 4)), (mats["lin"][:, n:], range(-4, 5)),
              (mats["up"][:, :n], range(0, 5)), (mats["up"][:, n:], range(-4, 1))]
    at = 0
    for w, offsets in blocks:
        entries = np.array([w[d % n, 0] for d in offsets], np.float32)
        hi, lo = T.limbs(torch.as_tensor(entries))
        k = len(entries)
        np.testing.assert_array_equal(taps[at : at + k], hi.numpy())
        np.testing.assert_array_equal(taps[at + k : at + 2 * k], lo.numpy())
        at += 2 * k
        # Circulant: each column is the first rolled, nothing outside the taps.
        mask = np.zeros(n, bool)
        mask[[d % n for d in offsets]] = True
        assert not w[~mask, 0].any()
        np.testing.assert_array_equal(w[:, 5], np.roll(w[:, 0], 5))


# --------------------------------------------------------------- limb product
def test_packed_precision_limbs_consistent():
    """bf16 limb splitting is exact: hi + lo == W in float32 for the
    operators, and the two-limb error of a float32 field is ~2^-17."""
    ops, _ = _ops()
    for w in T.packed_matrices(ops):
        wt = torch.as_tensor(w)
        hi = T.bf16_round(wt)
        np.testing.assert_array_equal((hi + (wt - hi)).numpy(), w)
    x = torch.as_tensor(np.array(jax.random.normal(jax.random.PRNGKey(0), (4, 128),
                                                   jnp.float32)))
    hi, lo = T.limbs(x)
    err = float(torch.max(torch.abs(hi + lo - x) / (torch.abs(x) + 1e-9)))
    assert err < 2**-15
    # The rounding is to nearest, ties to even, and keeps bf16 values.
    assert T.bf16_round(torch.tensor([1 + 2**-8, 1 + 3 * 2**-8])).tolist() == [1.0, 1 + 2**-6]
    assert torch.equal(T.bf16_round(hi), hi) and torch.equal(T.bf16_round(lo), lo)


def test_limb_dot_presummed_linear_bias_regression():
    """Regression for the bf16-limb attractor drain: under 3-pass limb
    arithmetic the PRE-SUMMED linear operator carries a systematic signed
    error aligned with the state (an effective-viscosity shift), and the
    separate-block layout does not.  Same inputs as the JAX test; the
    port's ``limb_dot`` is that test's emulated kernel dot."""
    ops, _ = _ops()
    n = 64
    wl_sum, _ = T.packed_matrices(ops)
    wl_sep = T.packed_linear_separate(ops)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (256, 2 * n), jnp.float32))

    def smooth(v):
        f = np.fft.rfft(np.asarray(v, np.float64), axis=-1)
        f[:, 12:] = 0
        return np.fft.irfft(f, axis=-1).astype(np.float32)

    xs = np.concatenate([smooth(x[:, :n]), smooth(x[:, n:])], -1) * np.float32(1.5)
    exact = (xs.astype(np.float64) @ wl_sum.astype(np.float64)).astype(np.float32)
    y_sum = T.limb_dot(_t(xs), _t(wl_sum), "bf16_3x").numpy()
    y_sep4 = T.limb_dot(_t(xs), _t(wl_sep), "bf16_3x").numpy()
    y_sep = y_sep4[:, : 2 * n] + y_sep4[:, 2 * n :]

    bias_sum = float(np.mean((y_sum - exact) * xs))
    bias_sep = float(np.mean((y_sep - exact) * xs))
    # The JAX test measured presummed -4.7e-3, separate +2.3e-4 at this seed.
    assert abs(bias_sum) > 2e-3, bias_sum
    assert abs(bias_sep) < 5e-4, bias_sep
    assert abs(bias_sum) > 5 * abs(bias_sep), (bias_sum, bias_sep)


@pytest.mark.parametrize("precision,rel", [("bf16_3x", 2**-15), ("bf16_4x", 2**-15),
                                           ("bf16", 2**-7)])
def test_limb_dot_is_unbiased_where_jax_cpu_is_not(precision, rel):
    """On the separate operator the port's limb product is within 2^-15 of
    the exact float64 product (relative to its largest entry); JAX's
    ``_make_dot`` on the CPU counts ``W_lo`` twice and is off by ~2e-3."""
    ops, _ = _ops()
    w = T.packed_linear_separate(ops)
    x = np.random.default_rng(0).normal(size=(16, 128)).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).max()
    got = T.limb_dot(_t(x), _t(w), precision).numpy()
    assert np.abs(got - exact).max() / scale < rel
    if precision != "bf16":
        wj = jnp.asarray(w, jnp.float32)
        w_lo = wj - wj.astype(jnp.bfloat16).astype(jnp.float32)
        jax_cpu = np.asarray(P._make_dot(precision)(jnp.asarray(x), wj, w_lo))
        assert np.abs(jax_cpu - exact).max() / scale > 1e-3


# ------------------------------------------------------- period against JAX
def _tpu_make_dot(precision):
    """The TPU's arithmetic for ``_make_dot``: every MXU operand rounded to
    bf16, products accumulated in float32."""
    def rnd(v):
        return v.astype(jnp.bfloat16).astype(jnp.float32)

    def dot(x, w, w_lo):
        hi = rnd(x)
        lo = rnd(x - hi)
        wh, wl = rnd(w), rnd(w_lo)
        hp = jax.lax.Precision.HIGHEST
        y = jnp.dot(hi, wh, precision=hp)
        if precision == "bf16":
            return y
        y = y + jnp.dot(hi, wl, precision=hp)
        y = y + jnp.dot(lo, wh, precision=hp)
        if precision == "bf16_4x":
            y = y + jnp.dot(lo, wl, precision=hp)
        return y
    return dot


@pytest.fixture
def tpu_arithmetic(monkeypatch):
    """Swap the JAX kernel's dot for the TPU's arithmetic; ``_call`` is
    jitted on its static arguments, so its cache is cleared around the swap."""
    jax.clear_caches()
    monkeypatch.setattr(P, "_make_dot", _tpu_make_dot)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _jax_period(u, phi, objective, precision):
    _, jops = _ops()
    ju, jr = P.ks_control_period_packed(jops, jnp.asarray(u), jnp.asarray(phi), 1e-3, 20,
                                        objective, block=4, precision=precision,
                                        interpret=True)
    return np.asarray(ju), np.asarray(jr)


def _port_period(u, phi, objective, precision):
    ops, _ = _ops()
    tu, tr = T.ks_control_period_packed_plain(ops, _t(u), _t(phi), 1e-3, 20, objective,
                                              precision)
    return tu.numpy(), tr.numpy()


def _inputs():
    rng = np.random.default_rng(0)
    return _smooth(rng, 8, 6.0), _smooth(rng, 8, 0.5)


@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_plain_period_matches_jax_kernel(objective, precision):
    """``highest`` and one-pass ``bf16`` compute the same on the CPU as on
    the TPU: held against JAX's own wrapper in interpret mode."""
    u, phi = _inputs()
    ju, jr = _jax_period(u, phi, objective, precision)
    tu, tr = _port_period(u, phi, objective, precision)
    np.testing.assert_allclose(tu, ju, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr, jr, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
@pytest.mark.parametrize("precision", ["bf16_3x", "bf16_4x"])
def test_plain_period_matches_jax_kernel_tpu_arithmetic(tpu_arithmetic, objective,
                                                        precision):
    u, phi = _inputs()
    ju, jr = _jax_period(u, phi, objective, precision)
    tu, tr = _port_period(u, phi, objective, precision)
    np.testing.assert_allclose(tu, ju, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr, jr, rtol=1e-4, atol=1e-4)


def test_jax_make_dot_is_restored_after_the_swap():
    assert P._make_dot is not _tpu_make_dot
    u, phi = _inputs()
    # The JAX CPU limb mode (W_lo counted twice) differs from the TPU's.
    jcpu, _ = _jax_period(u[:2], phi[:2], "l2control", "bf16_3x")
    tu, _ = _port_period(u[:2], phi[:2], "l2control", "bf16_3x")
    assert np.abs(jcpu - tu).max() > 1e-3


# ------------------------------------------------------------------- wrapper
def test_wrapper_routes_highest_to_k1_and_limb_modes_to_the_plain_version(monkeypatch):
    ops, _ = _ops()
    rng = np.random.default_rng(1)
    u, phi = _t(_smooth(rng, 4, 2.0)), _t(_smooth(rng, 4, 0.3))
    seen = []
    monkeypatch.setattr(pallas_ks, "ks_control_period",
                        lambda *a: seen.append("k1") or (a[1], a[1][:, 0]))
    T.ks_control_period_packed(ops, u, phi, 1e-3, 2, precision="highest")
    assert seen == ["k1"]
    monkeypatch.undo()
    before = T.launch_count
    for precision in LIMB_MODES:
        for objective in ("l2control", "dissipation"):
            got = T.ks_control_period_packed(ops, u, phi, 1e-3, 3, objective, precision)
            ref = T.ks_control_period_packed_plain(ops, u, phi, 1e-3, 3, objective,
                                                   precision)
            for g, r in zip(got, ref):
                assert torch.equal(g, r)
    assert T.launch_count == before  # CPU tensors never launch the kernel


def test_packed_wrapper_selects_separate_layout_for_limb_modes(monkeypatch):
    """Limb modes multiply by the separate-block ``[N, 2N]`` linear operator;
    ``highest`` (the plain version's, and K1's) by the pre-summed one."""
    ops, _ = _ops()
    seen = []
    real = T.unpacked_operators

    def spy(ops_, precision):
        mats = real(ops_, precision)
        seen.append(mats["lin"].shape)
        return mats

    monkeypatch.setattr(T, "unpacked_operators", spy)
    u = torch.zeros(4, 64)
    T.ks_control_period_packed(ops, u, u, 1e-3, 2, precision="bf16_3x")
    assert seen == [(64, 128)]
    T.ks_control_period_packed_plain(ops, u, u, 1e-3, 2, precision="highest")
    assert seen == [(64, 128), (64, 64)]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ops, _ = _ops()
    u = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="precision"):
        T.ks_control_period_packed(ops, u, u, 1e-3, 2, precision="bf16_2x")
    with pytest.raises(ValueError, match="objective"):
        T.ks_control_period_packed(ops, u, u, 1e-3, 2, "energy", "bf16_3x")
    with pytest.raises(TypeError):
        T.ks_control_period_packed(ops, u.double(), u.double(), 1e-3, 2,
                                   precision="bf16_3x")
    with pytest.raises(ValueError):
        T.ks_control_period_packed(ops, u[0], u[0], 1e-3, 2, precision="bf16_3x")
    with pytest.raises(ValueError):
        T.ks_control_period_packed(ops, torch.zeros(4, 32), u, 1e-3, 2, precision="bf16")
    meta = torch.zeros(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        T.ks_control_period_packed(ops, meta, meta, 1e-3, 2, precision="bf16_3x")


# ------------------------------------------------------------------------ env
ENV_TOL = {"highest": (3e-5, 3e-6), "bf16_3x": (1e-4, 1e-4), "bf16_4x": (1e-4, 1e-4),
           # One pass keeps 8 bits of every operand: ~2^-9 relative per term.
           "bf16": (2e-2, 2e-3)}


@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
@pytest.mark.parametrize("precision", ["highest", "bf16", "bf16_3x", "bf16_4x"])
def test_env_pallas_packed_matches_xla(objective, precision):
    je = jenv.KuramotoSivashinsky.create(n=16, cfg_steps=5, dtype=jnp.float32,
                                         objective=objective, legacy_objective=False)
    te = tenv.KuramotoSivashinsky.create(n=16, cfg_steps=5, objective=objective,
                                         legacy_objective=False, solver="pallas_packed",
                                         pallas_precision=precision)
    rtol, atol = ENV_TOL[precision]
    rng = np.random.default_rng(0)
    u = rng.uniform(-1.5, 1.5, (4, 16)).astype(np.float32)
    js = jenv.EnvState(u=jnp.asarray(u), step=jnp.zeros(4, jnp.int32),
                       key=jax.random.PRNGKey(0))
    ts = tenv.EnvState(u=torch.as_tensor(u), step=torch.zeros(4, dtype=torch.int32))
    for _ in range(3):
        a = rng.uniform(-1, 1, (4, 1, 4)).astype(np.float32)
        js, jo = je.step(js, jnp.asarray(a))
        ts, to = te.step(ts, torch.as_tensor(a))
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), rtol=rtol, atol=atol)
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("shape", [(3,), (1,), (), (3, 5)])
def test_env_odd_flat_batch_goes_to_k1_in_float32(monkeypatch, shape):
    """The JAX env sends an odd flat batch to the float32 kernel and drops
    the precision; an even one goes to K2."""
    calls = []
    real = T.ks_control_period_packed
    monkeypatch.setattr(T, "ks_control_period_packed",
                        lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
    env = tenv.KuramotoSivashinsky.create(n=16, cfg_steps=5, solver="pallas_packed",
                                          pallas_precision="bf16")
    ref = tenv.KuramotoSivashinsky.create(n=16, cfg_steps=5, solver="pallas")
    rng = np.random.default_rng(2)
    u = torch.as_tensor(rng.uniform(-1, 1, shape + (16,)).astype(np.float32))
    a = torch.as_tensor(rng.uniform(-1, 1, shape + (1, 4)).astype(np.float32))
    state = tenv.EnvState(u=u, step=torch.zeros(shape, dtype=torch.int32))
    (_, got), (_, want) = env.step(state, a), ref.step(state, a)
    assert torch.equal(got.obs, want.obs) and torch.equal(got.reward, want.reward)
    assert calls == []
    even = tenv.EnvState(u=torch.cat([u.reshape(-1, 16)] * 2),
                         step=torch.zeros(2 * u[..., 0].numel(), dtype=torch.int32))
    _, out = env.step(even, torch.cat([a.reshape(-1, 1, 4)] * 2))
    assert calls == [(2 * u[..., 0].numel(), 16)]
    assert not torch.equal(out.obs[: u[..., 0].numel(), 0], want.obs.reshape(-1, 16))


def test_reset_pool_under_pallas_packed_is_the_float32_pool():
    """The reset transient stays on K1 under ``pallas_packed``: the pool is
    the ``pallas`` pool, bit for bit, for the same generator."""
    kw = {"n": 16, "cfg_steps": 5, "transient_time": 0.05}
    packed = tenv.KuramotoSivashinsky.create(solver="pallas_packed",
                                             pallas_precision="bf16_3x", **kw)
    k1 = tenv.KuramotoSivashinsky.create(solver="pallas", **kw)
    pools = [tenv.make_reset_pool(env, torch.Generator().manual_seed(0), 10, chains=4,
                                  decorrelate_periods=2) for env in (packed, k1)]
    assert torch.equal(pools[0], pools[1])
    g = torch.Generator().manual_seed(1)
    assert torch.equal(packed.reset(g, (2,)).u,
                       k1.reset(torch.Generator().manual_seed(1), (2,)).u)


def test_env_create_checks_precision_and_dtype():
    env = tenv.KuramotoSivashinsky.create(solver="pallas_packed", pallas_precision="bf16_4x")
    assert env.pallas_precision == "bf16_4x" and env.solver == "pallas_packed"
    assert tenv.KuramotoSivashinsky.create().pallas_precision == "highest"
    with pytest.raises(ValueError, match="pallas_precision"):
        tenv.KuramotoSivashinsky.create(solver="pallas_packed", pallas_precision="fp8")
    with pytest.raises(ValueError, match="float32"):
        tenv.KuramotoSivashinsky.create(solver="pallas_packed", dtype=torch.float64)
    with pytest.raises(TypeError):
        tenv.KuramotoSivashinsky.create(solver="pallas_packed", pallas_block=512)
