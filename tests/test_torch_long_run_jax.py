"""What only a long MBPO run reaches, held to the JAX package on the CPU
(``tests/test_torch_long_run.py`` holds the same paths port against port):

  * the world replay after its ring has wrapped: the same writes leave the
    same buffers, the same row weights (``_row_weights``) and, since
    jax.random and torch draw different streams, the same distribution of
    ``sample_transitions`` and ``sample_windows`` draws, each held to the
    exact one;
  * the real / imagined mix of the SAC batches at the flagship's sizes: both
    replays' sizes and the share of imagined rows (``p_imag``) after each of
    the flagship's first 35 iterations (the world replay wraps from
    iteration 30);
  * the elites after members stopped at different epochs: a lock-step fit
    whose every draw is the same window (one window per row, the rows
    alike), so that the JAX package's whole-fit program and the port's fit
    take the same steps, stop each member at the same epoch, return the
    same scores and pick the same elites.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrol_tpu.data import replay as JR
from pdecontrol_tpu.envs.transforms import Identity as JIdentity
from pdecontrol_tpu.envs.transforms import SampleTransform as JSampleTransform
from pdecontrol_tpu.models import factories as JF
from pdecontrol_tpu.models.surrogate import EnsembleState as JEnsembleState
from pdecontrol_tpu.models.surrogate import update_elites as j_update_elites
from pdecontrol_tpu.train import trainer as JTrn
from pdecontrol_tpu.train.losses import mse_loss as j_mse
from pdecontrol_tpu.train.schedulers import ConstantLengthScheduler as JConstant
from pdecontrol_tpu.train.schedulers import Scheduler as JScheduler
from pdecontrol_tpu_torch import convert
from pdecontrol_tpu_torch.data import replay as TR
from pdecontrol_tpu_torch.envs import transforms as TT
from pdecontrol_tpu_torch.models import factories as TF
from pdecontrol_tpu_torch.models.surrogate import EnsembleState, update_elites
from pdecontrol_tpu_torch.train import trainer as TTrn
from pdecontrol_tpu_torch.train.losses import make_loss
from pdecontrol_tpu_torch.train.schedulers import ConstantLengthScheduler

from .test_torch_long_run import FLAGSHIP_SCHEDULE


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def _world_writes(jrep, trep, horizons, obs_of):
    """Imagined rounds: every env of the batch runs ``h`` steps and is then
    truncated, as the world env's rounds are; ``obs_of(step)`` gives each
    write's observations.  Returns both replays."""
    n = trep.num_envs
    zeros = np.zeros(n, bool)
    step = 0
    for h in horizons:
        for t in range(h):
            obs, nxt = obs_of(step), obs_of(step) + 0.5
            act = np.full((n, 1, 1), float(step))
            rew = -np.arange(n, dtype=np.float64) - step
            trunc = np.full(n, t == h - 1)
            args = (obs, act, rew, zeros, trunc, nxt, np.full(n, t + 1, np.int32))
            jrep = JR.write_step(jrep, *(jnp.asarray(a) for a in args))
            TR.write_step(trep, *(torch.as_tensor(a) for a in args))
            step += 1
    return jrep, trep


def test_world_replay_after_wrap_matches_jax():
    rows, ep_len, envs = 7, 9, 2
    jrep = JR.create(rows, ep_len, envs, (1, 1), (1, 1), jnp.float64)
    trep = TR.create(rows, ep_len, envs, (1, 1), (1, 1), torch.float64)
    # Each write's obs is its id (step * envs + env), so a draw names its
    # transition.
    jrep, trep = _world_writes(jrep, trep, [3, 4, 5, 6, 7, 7, 7, 3],
                               lambda s: (s * envs + np.arange(envs))[:, None, None] * 1.0)
    assert int(trep.next_row) > 2 * rows  # wrapped twice
    for f in ("obs_seq", "actions", "rewards", "terminated", "truncated", "steps", "fill",
              "complete", "row_of_env", "next_row", "total_steps"):
        _same(getattr(trep, f), getattr(jrep, f))
    fill = trep.fill.numpy()
    for length in (1, 3):
        _same(TR._row_weights(trep, length), JR._row_weights(jrep, length))
    assert int(trep.ntimesteps) == int(jrep.ntimesteps) == fill.sum() > 0

    draws = 200_000
    # Transitions: uniform over the stored ones.
    ids = {int(trep.obs_seq[r, t, 0, 0]) for r in range(rows) for t in range(fill[r])}
    want = {i: 1 / len(ids) for i in ids}
    j = JR.sample_transitions(jrep, jax.random.PRNGKey(0), draws)
    t = TR.sample_transitions(trep, torch.Generator().manual_seed(0), draws)
    for obs in (np.asarray(j.obs), t.obs.numpy()):
        got, counts = np.unique(obs.reshape(-1).astype(int), return_counts=True)
        assert set(got) == ids
        np.testing.assert_allclose(counts / draws, [want[i] for i in got], atol=4e-3)
    # Windows of 3: rows by their window counts, starts uniform in a row.
    weights = np.maximum(fill - 2, 0)
    starts = {(int(trep.obs_seq[r, s, 0, 0])): weights[r] / weights.sum() / (fill[r] - 2)
              for r in range(rows) for s in range(max(fill[r] - 2, 0))}
    j = JR.sample_windows(jrep, jax.random.PRNGKey(1), draws, 3)
    t = TR.sample_windows(trep, torch.Generator().manual_seed(1), draws, 3)
    for obs in (np.asarray(j.obs), t.obs.numpy()):
        got, counts = np.unique(obs[:, 0].reshape(-1).astype(int), return_counts=True)
        assert set(got) == set(starts)
        np.testing.assert_allclose(counts / draws, [starts[i] for i in got], atol=4e-3)


def test_sac_batch_mix_at_flagship_sizes_matches_jax():
    """The flagship's replays (``runscripts/mbpo_ks.sh``: 10 envs, 400-step
    episodes, capacity 1e6; 100 imagined rows a round, 10 rounds an
    iteration, 30 iterations' rollouts kept, horizon 3 -> 7) through both
    packages' ``write_step`` at a width of 1: after each iteration the
    replays' sizes and the SAC batches' share of imagined rows agree."""
    envs, ep_len, batch, rounds = 10, 400, 100, 10
    h_max = 7
    w_rows = min(30 * 100 * envs, 1_000_000 // h_max)
    jreal = JR.create(1_000_000 // ep_len, ep_len, envs, (1, 1), (1, 1), jnp.float32)
    treal = TR.create(1_000_000 // ep_len, ep_len, envs, (1, 1), (1, 1), torch.float32)
    jworld = JR.create(w_rows, h_max + 2, batch, (1, 1), (1, 1), jnp.float32)
    tworld = TR.create(w_rows, h_max + 2, batch, (1, 1), (1, 1), torch.float32)
    jwrite = jax.jit(JR.write_step)
    schedule = JScheduler.factory(FLAGSHIP_SCHEDULE)
    zeros = np.zeros(envs, bool)

    def real_steps(jreal, count, start):
        for k in range(count):
            step = start + k
            trunc = np.full(envs, (step + 1) % ep_len == 0)
            args = (np.zeros((envs, 1, 1)), np.zeros((envs, 1, 1)), np.zeros(envs), zeros,
                    trunc, np.zeros((envs, 1, 1)), np.full(envs, step % ep_len + 1, np.int32))
            jreal = jwrite(jreal, *(jnp.asarray(a) for a in args))
            TR.write_step(treal, *(torch.as_tensor(a) for a in args))
        return jreal

    jreal = real_steps(jreal, 500, 0)  # the 5,000-step warmup
    wzeros, ones = np.zeros((batch, 1, 1)), np.ones(batch)
    for it in range(35):
        jreal = real_steps(jreal, 1, 500 + it)
        h = int(schedule(iteration=it))
        for _ in range(rounds):
            for t in range(h):
                args = (wzeros, wzeros, ones, np.zeros(batch, bool), np.full(batch, t == h - 1),
                        wzeros, np.full(batch, t + 1, np.int32))
                jworld = jwrite(jworld, *(jnp.asarray(a) for a in args))
                TR.write_step(tworld, *(torch.as_tensor(a) for a in args))
        j_imag = jworld.ntimesteps.astype(jnp.float32) / jnp.maximum(
            jworld.ntimesteps + jreal.ntimesteps, 1).astype(jnp.float32)
        w_n = tworld.ntimesteps.to(torch.float32)
        t_imag = w_n / torch.clamp(w_n + treal.ntimesteps, min=1)
        assert int(tworld.ntimesteps) == int(jworld.ntimesteps)
        assert int(treal.ntimesteps) == int(jreal.ntimesteps) == 5000 + 10 * (it + 1)
        assert float(t_imag) == float(j_imag), it
    # Wrapped: the world replay holds 30,000 rows, 100 of them claimed and
    # empty, of horizon-3 rollouts (the horizon is 3 to iteration 49).
    assert int(tworld.next_row) > w_rows
    assert int(tworld.ntimesteps) == (w_rows - batch) * 3


M, B, N, L = 3, 2, 8, 4  # members, batch, width, window length (tau 2 + K 2)
# A large lr, so that a member's val loss climbs now and then and patience 1
# stops it.
CFG = dict(tau=2, tbtt=4, lr=0.2, lr_gamma=0.7, step_size=2, batch_size=B, patience=1,
           max_epochs=12, min_steps=2)


def test_elites_after_members_stop_at_different_epochs_match_jax():
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(L + 1, 1, N))
    actions = rng.uniform(-1, 1, (L, 1, N))
    rows = 6  # 4 train rows and 2 val rows, each one window long
    obs_seq = np.broadcast_to(frames, (rows,) + frames.shape).copy()
    act = np.broadcast_to(actions, (rows,) + actions.shape).copy()
    fill = np.full(rows, L, np.int32)
    train = np.arange(rows) < 4

    jm = JF.make("KSAutoRegFullyConnectedLSTM", delta=0.25, N=N)
    jtr = JTrn.SurrogateTrainer(jm, j_mse, JTrn.TrainConfig(**CFG))
    x = jnp.zeros((1, 2, 1, N))
    # float32, as the JAX package's whole-fit program carries its losses.
    params = [jax.tree.map(lambda p: np.asarray(p, np.float32),
                           jm.init(jax.random.PRNGKey(i), x, x)["params"]) for i in range(M)]
    stacked = jax.tree.map(lambda *p: jnp.stack(p), *params)
    opt_state = jtr.opt.init(stacked)
    opt_state = tuple(s._replace(count=jnp.zeros((M,), jnp.int32)) if hasattr(s, "mu") else s
                      for s in opt_state)
    jstate = JTrn.TrainerState(params=stacked, opt_state=opt_state,
                               global_step=jnp.zeros((M,), jnp.int32))
    jrep = JR.create(rows, L, 1, (1, N), (1, N), jnp.float32).replace(
        obs_seq=jnp.asarray(obs_seq, jnp.float32), actions=jnp.asarray(act, jnp.float32),
        fill=jnp.asarray(fill))
    jstate, jvl, jlogs = jtr.fit_ensemble(
        jstate, jrep, jnp.asarray(train), jnp.asarray(~train), JIdentity(), JSampleTransform(),
        JConstant(length=2), iteration=0, key=jax.random.PRNGKey(3))
    assert "t_fit_ready" in jlogs  # the whole-fit program, the flagship's route

    modules = [TF.make("KSAutoRegFullyConnectedLSTM", delta=0.25, N=N) for _ in range(M)]
    (adam,) = [s for s in opt_state if hasattr(s, "mu")]
    tstate = convert.stacked_trainer_state(
        modules, jax.tree.map(np.asarray, stacked), jax.tree.map(np.asarray, adam.mu),
        jax.tree.map(np.asarray, adam.nu), np.zeros(M, np.int64), np.zeros(M, np.int64))
    trep = TR.create(rows, L, 1, (1, N), (1, N), torch.float32)
    trep.obs_seq.copy_(torch.as_tensor(obs_seq))
    trep.actions.copy_(torch.as_tensor(act))
    trep.fill.copy_(torch.as_tensor(fill))
    ttr = TTrn.SurrogateTrainer(make_loss("MSELoss", {}), TTrn.TrainConfig(**CFG))
    tstate, tvl, tlogs = ttr.fit_ensemble(
        tstate, trep, torch.as_tensor(train), torch.as_tensor(~train), TT.Identity(),
        TT.SampleTransform(), ConstantLengthScheduler(length=2), 0,
        torch.Generator().manual_seed(3))

    steps = tstate.global_step.tolist()
    assert len(set(steps)) > 1  # the members stopped at different epochs
    assert steps == np.asarray(jstate.global_step).tolist()
    assert tlogs["epochs"] == jlogs["epochs"] and tlogs["steps"] == jlogs["steps"]
    np.testing.assert_allclose(tvl, np.asarray(jvl), rtol=1e-4)
    elites = update_elites(EnsembleState(torch.nn.ModuleList(modules), torch.zeros(M, dtype=bool),
                                         num_elites=2), torch.as_tensor(tvl)).elite_mask
    jelites = j_update_elites(JEnsembleState(params=None, elite_mask=jnp.zeros(M, bool),
                                             num_elites=2), jnp.asarray(jvl)).elite_mask
    _same(elites, jelites)
