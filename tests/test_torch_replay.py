"""Port parity of the episodic replay against the JAX package: the same
writes (made with numpy, ring eviction and an early termination included)
leave the same buffers, and the deterministic reads (window enumeration,
episode returns, delta statistics) agree.  The seeded samplers are held to
what they may return, since jax.random and torch draw different streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.data import replay as JR
from pdecontrol_tpu_torch.data import replay as TR

ROWS, EP_LEN, ENVS, OBS, ACT = 5, 4, 3, (1, 8), (1, 4)
FIELDS = ("obs_seq", "actions", "rewards", "terminated", "truncated", "steps",
          "fill", "complete", "row_of_env", "next_row", "total_steps")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Affine:
    """An observation transform both packages can apply."""

    def apply(self, x):
        return 2.0 * x + 1.0


def _filled(n_writes=11):
    """Both replays after ``n_writes`` vectorised steps.  The envs start at
    staggered episode steps, so rows end at different times; env 1
    terminates once mid-episode; 11 writes wrap the 5-row ring."""
    jrep = JR.create(ROWS, EP_LEN, ENVS, OBS, ACT, jnp.float64)
    trep = TR.create(ROWS, EP_LEN, ENVS, OBS, ACT, torch.float64)
    rng = np.random.default_rng(0)
    step = np.array([0, 1, 2])
    obs = rng.normal(size=(ENVS,) + OBS)
    for t in range(n_writes):
        nxt = rng.normal(size=(ENVS,) + OBS)
        act = rng.uniform(-1, 1, (ENVS,) + ACT)
        rew = rng.normal(size=ENVS)
        step = step + 1
        truncated = step >= EP_LEN
        terminated = np.zeros(ENVS, bool)
        terminated[1] = t == 3 and not truncated[1]
        args = (obs, act, rew, terminated, truncated, nxt, step.astype(np.int32))
        jrep = JR.write_step(jrep, *(jnp.asarray(a) for a in args))
        TR.write_step(trep, *(torch.as_tensor(a) for a in args))
        step = np.where(terminated | truncated, 0, step)
        obs = rng.normal(size=(ENVS,) + OBS)
    return jrep, trep


def _same(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


@pytest.mark.parametrize("n_writes", [3, 11])
def test_write_step_matches_jax(n_writes):
    jrep, trep = _filled(n_writes)
    for name in FIELDS:
        _same(getattr(trep, name), getattr(jrep, name))
    assert int(trep.ntimesteps) == int(jrep.ntimesteps)
    assert int(trep.ncomplete) == int(jrep.ncomplete)


@pytest.mark.parametrize("length,stride,masked", [
    (2, None, False), (2, 1, False), (3, 1, True), (4, None, True)])
def test_enumerate_windows_matches_jax(length, stride, masked):
    jrep, trep = _filled()
    mask = np.array([True, False, True, True, False]) if masked else None
    jw = JR.enumerate_windows(jrep, length, stride,
                              None if mask is None else jnp.asarray(mask))
    tw = TR.enumerate_windows(trep, length, stride,
                              None if mask is None else torch.as_tensor(mask))
    assert tw.obs.shape[0] > 0
    for t, j in zip(tw, jw):
        _same(t, j)


def test_episode_returns_and_delta_statistics_match_jax():
    jrep, trep = _filled()
    for t, j in zip(TR.episode_returns(trep), JR.episode_returns(jrep)):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-12)
    for t, j in zip(TR.delta_statistics(trep, _Affine(), 0.25),
                    JR.delta_statistics(jrep, _Affine(), 0.25)):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-12)


def _admissible(rep, length, lo_of_fill, rows):
    """Every window ``_gather_window`` can return for ``rows`` with starts in
    ``[lo_of_fill(fill), max(fill - length, 0)]`` (negative starts
    left-pad)."""
    fill = rep.fill.numpy()
    out = []
    for r in rows:
        for s in range(lo_of_fill(int(fill[r])), max(int(fill[r]) - length, 0) + 1):
            idx = np.clip(s + np.arange(length), 0, None)
            out.append(rep.obs_seq[r, idx].numpy())
    return out


def _drawn_from(windows, admissible):
    for w in windows:
        assert any(np.array_equal(w, a) for a in admissible)


def test_samplers_return_admissible_windows():
    _, trep = _filled()
    gen = torch.Generator().manual_seed(0)
    mask = torch.tensor([True, True, False, True, True])
    rows = np.nonzero(mask.numpy())[0]

    fill = trep.fill.numpy()
    w = TR.sample_windows(trep, gen, 32, 2, mask)
    _drawn_from(w.obs.numpy(), _admissible(trep, 2, lambda f: 0, rows[fill[rows] >= 2]))

    tau = 3
    s = TR.sample_starting(trep, gen, 32, tau)
    prefixes = _admissible(trep, tau, lambda f: -min(f, tau - 1), np.nonzero(fill)[0])
    _drawn_from(s.obs.numpy(), prefixes)

    x = TR.sample_transitions(trep, gen, 32)
    assert x.obs.shape == (32,) + OBS and x.rewards.shape == (32,)
    _drawn_from(x.obs.numpy()[:, None],
                _admissible(trep, 1, lambda f: 0, np.nonzero(fill)[0]))


def test_categorical_draw_follows_the_counts():
    """The rows' draw is proportional to their window counts (an int64
    inverse CDF), never picks a row without a window, and is uniform when
    no row has one (the JAX package's ``log(w + 1e-30)`` logits)."""
    gen = torch.Generator().manual_seed(0)
    counts = torch.tensor([0.0, 2.0, 0.0, 6.0, 2.0])
    draws = TR._categorical(counts, 200_000, gen)
    freq = torch.bincount(draws, minlength=5).double() / draws.numel()
    np.testing.assert_allclose(freq.numpy(), (counts / counts.sum()).numpy(), atol=5e-3)
    assert freq[0] == freq[2] == 0
    again = TR._categorical(counts, 200_000, torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)
    uniform = torch.bincount(TR._categorical(torch.zeros(4), 40_000, gen), minlength=4)
    np.testing.assert_allclose(uniform.numpy() / 40_000, 0.25, atol=1e-2)
