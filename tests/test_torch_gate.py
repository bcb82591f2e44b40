"""The bf16 attractor gate of the port against the JAX package on the CPU:
``compare`` on the same statistics, ``rollout_stats`` from the same initial
field (the one the JAX function draws from its key), its per-period
statistics buffered and reduced once as the JAX gate's scan outputs are,
and the CLI at a tiny size."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky as JEnv
from pdecontrol_tpu.evaluation import bf16_gate as JG
from pdecontrol_tpu_torch.envs.kuramoto import EnvState, KuramotoSivashinsky
from pdecontrol_tpu_torch.evaluation import bf16_gate as G
from pdecontrol_tpu_torch.ops.kuramoto import ks_derivatives


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = {"n": 32, "cfg_steps": 10}


def _jax_stats(seed=0):
    env = JEnv.create(dtype=jnp.float32, solver="xla", **KW)
    return JG.rollout_stats(env, jax.random.PRNGKey(seed), batch=8, transient=3, periods=6)


def _jax_ic(seed=0):
    """The initial field ``bf16_gate.rollout_stats`` draws (bf16_gate.py:48-51)."""
    ku, _ = jax.random.split(jax.random.PRNGKey(seed))
    return np.array(jax.random.uniform(ku, (8, KW["n"]), minval=-1.0, maxval=1.0,
                                       dtype=jnp.float32))


@pytest.mark.parametrize("solver,precision", [("xla", "highest"), ("pallas", "highest"),
                                              ("pallas_packed", "highest")])
def test_rollout_stats_matches_jax_on_the_same_ic(solver, precision):
    want = _jax_stats()
    env = KuramotoSivashinsky.create(solver=solver, pallas_precision=precision, **KW)
    got = G.rollout_stats_from(env, torch.as_tensor(_jax_ic()), transient=3, periods=6)
    assert got["spectrum"].shape == (KW["n"] // 2 + 1,)
    for k in ("mean_energy", "mean_ux2", "mean_uxx2"):
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    np.testing.assert_allclose(got["spectrum"], want["spectrum"], rtol=1e-4,
                               atol=1e-4 * want["spectrum"].max())


@pytest.mark.parametrize("precision", ["bf16_3x", "bf16_4x"])
def test_rollout_stats_of_the_limb_modes_are_close_to_float32(precision):
    """Over 9 periods from one field the limb modes stay on the float32
    trajectory (no time to decorrelate): the statistics agree to ~1e-4."""
    ic = torch.as_tensor(_jax_ic())
    fp32 = G.rollout_stats_from(KuramotoSivashinsky.create(solver="xla", **KW), ic, 3, 6)
    fast = G.rollout_stats_from(KuramotoSivashinsky.create(
        solver="pallas_packed", pallas_precision=precision, **KW), ic, 3, 6)
    verdict = G.compare(fp32, fast, rtol_means=1e-3, rtol_spec=1e-2)
    assert verdict["ok"], verdict


def test_buffered_statistics_are_the_per_period_loops():
    """The buffers hold each period's statistics in its own row: their
    reductions equal, bit for bit, those of a loop that keeps every
    period's statistics in a list and stacks them at the end (the JAX
    gate's scan body and outputs, ``bf16_gate.py:63-90``)."""
    env = KuramotoSivashinsky.create(solver="xla", **KW)
    u0 = torch.as_tensor(_jax_ic())
    got = G.rollout_stats_from(env, u0, transient=3, periods=6, graphs=False)
    state = EnvState(u=u0.clone(), step=torch.zeros((8,), dtype=torch.int32))
    actions = torch.zeros((8, 1, env.num_jets))
    for _ in range(3):
        state, _ = env.step(state, actions)
    rows, spec = [], []
    for _ in range(6):
        state, _ = env.step(state, actions)
        u_x, u_xx, _ = ks_derivatives(env.ops, state.u)
        rows.append([torch.mean(state.u * state.u), torch.mean(u_x * u_x),
                     torch.mean(u_xx * u_xx)])
        spec.append(torch.mean(torch.abs(torch.fft.rfft(state.u, dim=-1)) ** 2, dim=0))
    for i, k in enumerate(("mean_energy", "mean_ux2", "mean_uxx2")):
        assert got[k] == float(torch.stack([r[i] for r in rows]).mean()), k
    np.testing.assert_array_equal(got["spectrum"], torch.stack(spec).mean(0).numpy())


def test_rollout_stats_draws_from_the_generator():
    env = KuramotoSivashinsky.create(solver="xla", **KW)
    a = G.rollout_stats(env, torch.Generator().manual_seed(0), 8, 1, 2)
    b = G.rollout_stats(env, torch.Generator().manual_seed(0), 8, 1, 2)
    c = G.rollout_stats(env, torch.Generator().manual_seed(1), 8, 1, 2)
    assert a["mean_energy"] == b["mean_energy"] != c["mean_energy"]
    np.testing.assert_array_equal(a["spectrum"], b["spectrum"])


def _verdict_cases():
    s = _jax_stats()
    bad = copy.deepcopy(s)
    bad["mean_energy"] *= 1.05
    tail = copy.deepcopy(s)
    spec = tail["spectrum"].copy()
    spec[spec < 1e-4 * spec.max()] *= 10.0
    tail["spectrum"] = spec
    band = copy.deepcopy(s)
    band["spectrum"] = s["spectrum"] * 1.2
    return s, {"same": s, "energy_bias": bad, "tail_only": tail, "band": band}


@pytest.mark.parametrize("case", ["same", "energy_bias", "tail_only", "band"])
def test_compare_matches_jax(case):
    s, cases = _verdict_cases()
    other = cases[case]
    want = JG.compare(s, other, rtol_means=0.02, rtol_spec=0.10)
    got = G.compare(s, other, rtol_means=0.02, rtol_spec=0.10)
    assert got == want
    assert got["ok"] == (case in ("same", "tail_only"))


def test_gate_cli_at_a_tiny_size(tmp_path):
    """``main`` at the full KS size with 2 envs for 1 + 2 periods: too short
    to decorrelate, so the verdict is a pass; the JSON lands in --output."""
    out = tmp_path / "verdict.json"
    rc = G.main(["--platform", "cpu", "--batch", "2", "--transient", "1", "--periods", "2",
                 "--precision", "bf16_3x", "--output", str(out)])
    verdict = json.loads(out.read_text())
    assert rc == 0 and verdict["ok"]
    assert verdict["config"] == {"batch": 2, "transient_periods": 1, "periods": 2,
                                 "total_agent_steps": 4, "precision": "bf16_3x",
                                 "device": "cpu"}
    assert verdict["spectrum"]["bins_compared"] > 0
