"""Kernels K1 and K2 of the port on grids other than the flagship's 64
points, against the JAX package on the CPU: every grid the JAX kernels
take, from 9 to 1,024 points (the CUDA kernels' register path takes n = 32,
64, ..., 256 and a shared-memory path the others; on the CPU each wrapper
runs its plain version, which is what these tests hold).

Every grid keeps the flagship's spacing, L = 22 n / 64: RK4 at dt = 1e-3
diverges on a finer one (at L = 22 and n = 100 JAX's kernel gives NaN).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs import kuramoto as jenv
from pdecontrol_tpu.ops import pallas_ks as jpallas
from pdecontrol_tpu.ops import pallas_ks_packed as jpacked
from pdecontrol_tpu.ops.kuramoto import KSOperators as JOps
from pdecontrol_tpu_torch.envs import kuramoto as tenv
from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed
from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

from .test_torch_packed import _smooth, _tpu_make_dot

OBJECTIVES = ("l2control", "dissipation")
LIMB_MODES = ("bf16", "bf16_3x", "bf16_4x")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _length(n):
    return 22.0 * n / 64


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("n", [16, 48, 100, 320, 512])
def test_k1_matches_jax_kernel_on_every_grid(n, objective):
    """K1's wrapper on CPU tensors against JAX's K1 in interpret mode, 20
    sub-steps at batch 4 (``tests/test_pallas_ks.py``'s tolerance)."""
    rng = np.random.default_rng(n)
    u = rng.uniform(-1.0, 1.0, (4, n)).astype(np.float32)
    phi = rng.uniform(-0.5, 0.5, (4, n)).astype(np.float32)
    jops = JOps.create(n, _length(n), dtype=jnp.float32)
    ju, jr = jpallas.ks_control_period_pallas(jops, jnp.asarray(u), jnp.asarray(phi), 1e-3,
                                              20, objective, block=4, interpret=True)
    ops = KSOperators.create(n, _length(n))
    before = pallas_ks.launch_count
    tu, tr = pallas_ks.ks_control_period(ops, _t(u), _t(phi), 1e-3, 20, objective)
    assert pallas_ks.launch_count == before  # CPU tensors never launch
    assert np.isfinite(np.asarray(ju)).all()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="class")
def tpu_arithmetic():
    """JAX's K2 body with the TPU's limb arithmetic (``_make_dot`` swapped,
    as ``tests/test_torch_packed.py`` does; its jit cache cleared around)."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpacked, "_make_dot", _tpu_make_dot)
        yield
    jax.clear_caches()


@pytest.mark.usefixtures("tpu_arithmetic")
class TestK2:
    @pytest.mark.parametrize("objective", OBJECTIVES)
    @pytest.mark.parametrize("precision", LIMB_MODES)
    @pytest.mark.parametrize("n", [16, 48, 320])
    def test_matches_jax_kernel_on_every_grid(self, n, precision, objective):
        """K2's plain version against JAX's K2 kernel body in interpret mode
        with the TPU's arithmetic, on smooth fields (as on the attractor),
        20 sub-steps at batch 8 (``tests/test_torch_packed.py``'s
        tolerance)."""
        rng = np.random.default_rng(n)
        u, phi = _smooth(rng, 8, 3.0, n), _smooth(rng, 8, 0.5, n)
        jops = JOps.create(n, _length(n), dtype=jnp.float32)
        ju, jr = jpacked.ks_control_period_packed(jops, jnp.asarray(u), jnp.asarray(phi),
                                                  1e-3, 20, objective, block=4,
                                                  precision=precision, interpret=True)
        ops = KSOperators.create(n, _length(n))
        before = pallas_ks_packed.launch_count
        tu, tr = pallas_ks_packed.ks_control_period_packed(ops, _t(u), _t(phi), 1e-3, 20,
                                                           objective, precision)
        assert pallas_ks_packed.launch_count == before
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_env_at_48_points_matches_jax_pallas_env(objective):
    """The env at 48 points with ``solver="pallas"`` (K1 in interpret mode
    on the JAX side, K1's wrapper on the port's) over 3 periods of 25
    sub-steps (``tests/test_env_solvers.py``'s tolerance)."""
    n = 48
    kw = dict(n=n, length=_length(n), cfg_steps=25, objective=objective,
              legacy_objective=False, solver="pallas")
    jax_env = jenv.KuramotoSivashinsky.create(pallas_interpret=True, **kw)
    env = tenv.KuramotoSivashinsky.create(**kw)
    rng = np.random.default_rng(48)
    u = _smooth(rng, 4, 2.0, n)
    js = jenv.EnvState(u=jnp.asarray(u), step=jnp.zeros(4, jnp.int32),
                       key=jax.random.PRNGKey(0))
    ts = tenv.EnvState(u=_t(u), step=torch.zeros(4, dtype=torch.int32))
    for _ in range(3):
        a = rng.uniform(-1, 1, (4, 1, 4)).astype(np.float32)
        js, jo = jax_env.step(js, jnp.asarray(a))
        ts, to = env.step(ts, _t(a))
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), rtol=3e-5, atol=3e-6)
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward), rtol=3e-5,
                                   atol=3e-6)


def _taps_by_roll_against_dense(n):
    """Largest gap, relative to the largest derivative, between the taps
    applied by ``torch.roll`` and the dense product, at one grid."""
    ops = KSOperators.create(n, _length(n))
    # Uncached: the caches would keep up to 16 operators of ~33 MB.
    taps = torch.as_tensor(pallas_ks.stencil_taps.__wrapped__(ops), dtype=torch.float64)
    c2, c4, fw, bw = taps[:7], taps[7:16], taps[16:21], taps[21:]
    u = torch.as_tensor(np.random.default_rng(n).uniform(-1.0, 1.0, (2, n)))
    sq = u * u

    def shifted(x, d):  # x[i + d], periodic
        return torch.roll(x, -d, dims=1)

    by_roll = torch.cat([
        sum(c2[d + 3] * shifted(u, d) for d in range(-3, 4)),
        sum(c4[d + 4] * shifted(u, d) for d in range(-4, 5)),
        sum(fw[d] * shifted(sq, d) for d in range(0, 5)),
        sum(bw[d + 4] * shifted(sq, d) for d in range(-4, 1)),
    ], dim=1)
    w = torch.as_tensor(pallas_ks.fused_stencil_matrix.__wrapped__(ops))
    # [u | u^2] @ w, by its two diagonal blocks once the others are zero.
    assert not w[:n, 2 * n:].any() and not w[n:, :2 * n].any()
    dense = torch.cat([u @ w[:n, :2 * n].double(), sq @ w[n:, 2 * n:].double()], dim=1)
    return float((by_roll - dense).abs().max()) / float(dense.abs().max())


def test_stencil_taps_by_roll_equal_the_dense_operator_on_every_grid():
    """The general kernel's arithmetic: the 26 taps of ``stencil_taps``
    applied as shifted copies of the periodic row (``torch.roll``), in
    float64, equal ``[u | u^2] @ fused_stencil_matrix`` (the JAX kernel's
    product) at every n from 9 to 1,024: no entry of the operator lies
    outside the taps, and the periodic wrap is the matrix's.  (The grids run
    on 4 threads: building 1,016 operators takes most of the time.)"""
    grids = range(pallas_ks.MIN_N, pallas_ks.MAX_N + 1)
    with ThreadPoolExecutor(4) as pool:
        gaps = dict(zip(grids, pool.map(_taps_by_roll_against_dense, grids)))
    assert len(gaps) == 1016
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < 1e-13, (worst, gaps[worst])


@pytest.mark.parametrize("n", [pallas_ks.MIN_N - 1, pallas_ks.MAX_N + 1])
def test_wrappers_decline_grids_outside_the_range_before_any_launch(n):
    ops = KSOperators.create(n, _length(n))
    u = torch.zeros(2, n)
    k1, k2 = pallas_ks.launch_count, pallas_ks_packed.launch_count
    with pytest.raises(ValueError, match="9 to 1024 points"):
        pallas_ks.ks_control_period(ops, u, u, 1e-3, 2)
    for precision in ("highest",) + LIMB_MODES:
        with pytest.raises(ValueError, match="9 to 1024 points"):
            pallas_ks_packed.ks_control_period_packed(ops, u, u, 1e-3, 2,
                                                      precision=precision)
    assert (pallas_ks.launch_count, pallas_ks_packed.launch_count) == (k1, k2)
