"""One tape of draws for the MBPO loop of both packages (the twin).

Every draw on the path of ``learn()`` comes from this tape, keyed by what
it means: the phase that draws (``init``, ``warmup``, ``collect``,
``imagine``, ``policy``, ``eval``, ``sur_eval``, ``fit``), the iteration,
the draw's role (the ``Role`` column of the draw-site table in
``PORTMAP.md``, which this module reads) and its place in the phase (the
step, the imagined round and step, the SAC update, the member).  So both
packages get the same draws although they batch them differently (the
port's lock-step fit draws ``M * B`` windows at once, the JAX package one
batch per member) and although the port skips a draw whose result the JAX
package discards (the world step's reset at a round's last step).  Three
configurations run on it (``TWINS``): the flagship's, the latent family's
and Burgers', each at its runscript's structure and a tiny size.

Where the packages reach one distribution by different algorithms the tape
supplies the outcome: replay rows and elite members are the inverse of the
weights' cumulative sum at a uniform from the tape, for both packages.  The
uniforms lie on a grid of 1/4096, so that every product the packages form
with them (a start within a row, an action in [-1, 1)) is exact in float32.

The port's side is installed here (``install_port``): ``torch.rand``,
``randn``, ``randint`` and ``multinomial`` answer from the tape when the
caller is a draw site of the table, pass through for callers outside the
port, and raise for a draw site of the port that the table lacks.  The JAX
package's side is ``tests/jax_twin.py``.  This module imports no JAX, so
that ``chip_smoke.py`` can run the port's side on the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import sys
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTMAP = os.path.join(ROOT, "PORTMAP.md")
JAX_PACKAGE, PORT_PACKAGE = "pdecontrol_tpu", "pdecontrol_tpu_torch"
GRID = 4096
SEED = 0

@dataclasses.dataclass(frozen=True)
class Twin:
    """One configuration of the twin: ``learn()``'s config, its iterations,
    the horizon of each, the iterations that retrain and those that
    evaluate."""
    config: Dict
    iterations: int
    horizons: Tuple[int, ...]
    retrains: Tuple[int, ...]
    evals: Tuple[int, ...]


# The flagship's structure (runscripts/mbpo_ks.sh) at the size of
# tests/test_torch_long_run.py: 8-step KS episodes on 32 points (K1's
# smallest grid on the card), 2 envs, a
# 4-step random warmup, 10 iterations with retrains at 0 and 5 (in the
# first, two members stop early, at different epochs, and the third at
# max_steps), the horizon climbing 2 -> 3, a world
# replay of 8 rows that wraps in iteration 2, SAC updates on mixed batches,
# evaluations at iterations 0, 4 and 8, and 3 members of which 2 are elites.
FLAGSHIP = dict(
    env_id="KuramotoSivashinskyEnv-v0",
    env_config={"n": 32, "cfg_steps": 5, "t_max": 0.04},
    num_envs=2, total_timesteps=8 + 2 * 10, learning_starts=8, capacity=512,
    pool_size=8, surrogate_train_freq=10, policy_train_steps_per_sample=1,
    model_rollouts_per_sample=2, model_rollouts_batch_size=4,
    model_buffer_store_iterations=2, model_buffer_max_capacity=64,
    num_dynamics_models=3, num_elite_models=2, policy_batch_size=8, hidden_size=32,
    agent_eval_freq=4, num_eval_episodes=2, surrogate_eval_horizon=4,
    status_report_freq=1000, logging_freq=0, precompile_horizons=False,
    factory="KSAutoRegConvolutionalLSTM", loss="MSELoss",
    rollout_length_schedule={"scheduler": "LinearScheduler", "steptype": "iteration",
                             "start": 0, "stop": 6, "vmin": 2, "vmax": 3},
    training={"tau": 2, "initial": {"tbtt": 4, "patience": 1, "batch_size": 4},
              "iterations": {"tbtt": 4, "patience": 1, "batch_size": 4}},
    trainer={"initial": {"min_steps": 2, "max_steps": 12},
             "iterations": {"min_steps": 1, "max_steps": 12}},
    curriculum={"scheduler": "ConstantLengthScheduler", "length": 2},
)
_STRUCTURE = dict(iterations=10, horizons=(2,) * 6 + (3,) * 4, retrains=(0, 5),
                  evals=(0, 4, 8))
TWINS = {
    "flagship": Twin(FLAGSHIP, **_STRUCTURE),
    # runscripts/mbpo_ks_latent_r4.sh: the flagship's arguments with the
    # KSLatentConvolutionalLSTM family (LATENT mode: encode, step in the
    # latent, decode; a world step re-encodes the previous prediction) and
    # its trainer overrides scaled as the flagship's are: max_steps of a
    # later retrain three times the flagship's, patience as the first
    # retrain's.  Its windows hold a TBPTT chunk boundary inside the loss,
    # as mbpo_ks.sh's 20-step windows do at step 10, so that the fit
    # self-forces on the re-encoded, detached prediction: a 5-step warmup
    # for 5-step windows (tau 2, the curriculum's scheduler at 3), chunks of
    # 3 steps.
    "latent": Twin({**FLAGSHIP, "factory": "KSLatentConvolutionalLSTM",
                    "learning_starts": 10, "total_timesteps": 10 + 2 * 10,
                    "curriculum": {"scheduler": "LinearScheduler", "steptype": "iteration",
                                   "start": 0, "stop": 10, "vmin": 3, "vmax": 3},
                    "training": {"tau": 2,
                                 "initial": {"tbtt": 3, "patience": 1, "batch_size": 4},
                                 "iterations": {"tbtt": 3, "patience": 1, "batch_size": 4}},
                    "trainer": {"initial": {"min_steps": 2, "max_steps": 12},
                                "iterations": {"min_steps": 1, "max_steps": 36}}},
                   **_STRUCTURE),
    # runscripts/mbpo_burgers.sh: the flagship's arguments on BurgersEnv-v0
    # (16 points, as tests/test_torch_slice_families.py), SAC's rewards
    # scaled by 500, and its curriculum's scheduler at the twin's length.
    "burgers": Twin({**FLAGSHIP, "env_id": "BurgersEnv-v0",
                     "env_config": {"n": 16, "cfg_steps": 5, "t_max": 0.04},
                     "reward_scale": 500.0,
                     "curriculum": {"scheduler": "LinearScheduler", "steptype": "iteration",
                                    "start": 0, "stop": 10, "vmin": 2, "vmax": 2}},
                    **_STRUCTURE),
}
# Fields of a record that read the host's clock or its garbage collector.
WALL_CLOCK = ("start", "time", "_time", "env_steps_per_sec", "gc_max_pause", "n_gc2")
# The port's counts of the lock-step fit and of the world step's auto-resets,
# which the JAX package does not log.
PORT_ONLY = ("fit_member_steps", "fit_masked_member_steps", "world_resets_drawn",
             "world_resets_run")


def shared_fields(record: Dict) -> Dict:
    """The fields of a ``metrics.jsonl`` record that do not read the clock
    and that both packages log."""
    return {k: v for k, v in record.items()
            if k not in WALL_CLOCK + PORT_ONLY and not k.startswith("t_")}


# ----------------------------------------------------------- the site table
@dataclasses.dataclass(frozen=True)
class Site:
    role: str
    supplies: str  # "draw" or "outcome"
    jax: Tuple[Tuple[str, int, str, str], ...]  # (file, line, qualname, callee)
    port: Tuple[Tuple[str, int, str, str], ...]


_CELL = re.compile(r"`([\w/]+\.py):(\d+)` `([\w.<>]+)` `(\w+)`")


def read_sites(path: str = PORTMAP) -> List[Site]:
    """The rows of ``PORTMAP.md``'s draw-site table: role, what the tape
    supplies, and each package's sites as (file, line, function, callee)."""
    with open(path) as f:
        text = f.read()
    table = text.split("## Draw sites", 1)[1].split("\n## ", 1)[0]
    sites = []
    for line in table.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) != 5 or not cells[0].startswith("`"):
            continue
        role, jax_cell, port_cell, _key, supplies = cells
        sites.append(Site(role.strip("`"), supplies.split()[0].strip("*:"),
                          tuple((f, int(n), q, c) for f, n, q, c in _CELL.findall(jax_cell)),
                          tuple((f, int(n), q, c) for f, n, q, c in _CELL.findall(port_cell))))
    return sites


def site_index(package: str) -> Dict[Tuple[str, str, str], str]:
    """(file in ``package``, function, callee) -> role."""
    out = {}
    for site in read_sites():
        for f, _, q, c in (site.jax if package == JAX_PACKAGE else site.port):
            out[(f, q, c)] = site.role
    return out


def caller(depth: int, package: str) -> Tuple[Optional[Tuple[str, str]], List[str]]:
    """The frame ``depth`` levels up as (file within ``package``, qualified
    function name), or None if it lies outside the package; and the
    qualified names of the package's frames above it, innermost first."""
    frame = sys._getframe(depth + 1)
    root = os.path.join(ROOT, package) + os.sep
    here, stack = None, []
    first = True
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(root):
            name = (path[len(root):].replace(os.sep, "/"), frame.f_code.co_qualname)
            if first:
                here = name
            stack.append(name[1])
        first = False
        frame = frame.f_back
    return here, stack


# ------------------------------------------------------------------ the tape
class Tape:
    """The draws of one run, keyed by meaning; ``phase`` sets what the key
    holds besides the role."""

    def __init__(self, seed: int = SEED, members: int = FLAGSHIP["num_dynamics_models"]):
        self.seed = seed
        self.members = members
        self.phase_name, self.iteration, self.horizon = "init", "init", None
        self.in_loop = False
        self.counts: Dict = {}
        self.keys: List[Tuple] = []
        self.fired: set = set()

    @contextmanager
    def phase(self, name: str, iteration, horizon: Optional[int] = None):
        saved = (self.phase_name, self.iteration, self.horizon, self.counts)
        self.phase_name, self.iteration, self.horizon = name, iteration, horizon
        self.counts = {}
        try:
            yield
        finally:
            self.phase_name, self.iteration, self.horizon, self.counts = saved

    def label(self, iteration: int):
        """The iteration in a key: the warmup and the evaluation after it
        come before iteration 0."""
        return iteration if self.in_loop else "warmup"

    @staticmethod
    def where(phase: str, stack: List[str]) -> Optional[str]:
        """Where in its phase a draw sits, from the caller's stack: an
        imagined round's ``start``, a world step's ``advance`` or the
        ``reset`` it draws for the next round; a fit's ``train`` or ``val``
        batch."""
        if phase == "imagine":
            if not any(q.endswith("WorldModel.step") for q in stack):
                return "start"
            return ("advance" if any(q.endswith("WorldModel.advance") for q in stack)
                    else "reset")
        if phase == "fit":
            return ("val" if any("one_val" in q or "val_body" in q for q in stack)
                    else "train")
        return None

    def key(self, role: str, where: Optional[str] = None, member: Optional[int] = None
            ) -> Tuple:
        ph, it = self.phase_name, self.iteration
        if ph == "imagine":
            # The actions drawn so far in this imagine phase place the draw:
            # a round's start reset comes before its first action, a world
            # step's draws after its action.
            a, h = self.counts.get("actions", 0), self.horizon
            if role == "policy.noise":
                self.counts["actions"] = a + 1
                key = (ph, it, role) + divmod(a, h)
            elif where == "start":
                key = (ph, it, role, where, a // h)
            else:
                key = (ph, it, role, where) + divmod(a - 1, h)
        else:
            c = (role, where, member)
            n = self.counts.get(c, 0)
            self.counts[c] = n + 1
            key = (ph, it, role, where, member, n)
        self.keys.append(key)
        return key

    def member_key(self, role: str, where: Optional[str]) -> Tuple:
        """The key of a draw made once for each member in turn, member 0
        first (the JAX package's vmapped fit): the n-th such draw of a role
        is member ``n % M``'s ``n // M``-th."""
        c = (role, where)
        n = self.counts.get(c, 0)
        self.counts[c] = n + 1
        key = (self.phase_name, self.iteration, role, where) + divmod(n, self.members)[::-1]
        self.keys.append(key)
        return key

    def rng(self, key: Tuple) -> np.random.Generator:
        digest = hashlib.blake2b(repr((self.seed,) + key).encode(), digest_size=8).digest()
        return np.random.default_rng(int.from_bytes(digest, "little"))

    def uniform(self, key: Tuple, shape) -> np.ndarray:
        return (self.rng(key).integers(0, GRID, shape) + 0.5) / GRID

    def normal(self, key: Tuple, shape) -> np.ndarray:
        return self.rng(key).standard_normal(shape)

    def integers(self, key: Tuple, shape, low: int, high: int) -> np.ndarray:
        return self.rng(key).integers(low, high, shape)

    def categorical(self, key: Tuple, weights: np.ndarray, n: int) -> np.ndarray:
        """``n`` indices with probability proportional to the whole-number
        ``weights``: the inverse of their cumulative sum at the tape's
        uniforms (uniform where every weight is 0)."""
        counts = np.rint(np.asarray(weights, np.float64)).astype(np.int64)
        if counts.sum() == 0:
            counts = np.ones_like(counts)
        cdf = np.cumsum(counts)
        target = np.minimum(np.floor(self.uniform(key, (n,)) * cdf[-1]).astype(np.int64),
                            cdf[-1] - 1)
        return np.searchsorted(cdf, target, side="right")


def reset_pool(tape: Tape, env, size: int) -> np.ndarray:
    """The reset pool of either package's ``env``, an outcome of the tape,
    float64 [size, n].  KS: smooth periodic fields of three Fourier modes
    (the attractor's scale).  Burgers: ``Burgers.sample_ic``'s fields, the
    sum of the ``ic_modes`` lowest sines at amplitudes in [-0.25, 0.25)
    and phases in [0, 2 pi), both from the tape."""
    rng = tape.rng(("pool",))
    n = env.n
    if hasattr(env, "ic_modes"):  # Burgers
        amps = rng.uniform(-0.25, 0.25, (size, env.ic_modes))
        phases = rng.uniform(0.0, 2 * np.pi, (size, env.ic_modes))
        x = np.linspace(0.0, env.length - env.length / n, n)
        k = np.arange(1, env.ic_modes + 1)
        waves = np.sin(2 * np.pi * k[:, None] * x[None, :] / env.length + phases[..., None])
        return (amps[..., None] * waves).sum(-2)
    x = 2 * np.pi * np.arange(n) / n
    amp = rng.normal(0.0, 0.6, (size, 3, 2))
    k = np.arange(1, 4)[None, :, None]
    return (amp[..., 0:1] * np.cos(k * x) + amp[..., 1:2] * np.sin(k * x)).sum(1)


# ----------------------------------------------------------- the port's side
def install_port(monkeypatch, tape: Tape, env_id: str, members=None, sac=None,
                 dtype=None) -> None:
    """Route the port's draws through ``tape`` (``monkeypatch`` undoes it):
    the four torch draw functions, ``env_id``'s reset pool, and, if given, the
    members' and the SAC networks' starting weights (state dicts, loaded in
    ``dtype``) in place of the port's own initialisation."""
    import torch

    from pdecontrol_tpu_torch.mbrl import controller as C

    index = site_index(PORT_PACKAGE)
    real = {name: getattr(torch, name) for name in ("rand", "randn", "randint", "multinomial")}

    def lookup(callee):
        here, stack = caller(2, PORT_PACKAGE)
        if here is None:
            return None, None
        role = index.get(here + (callee,))
        if role is None:
            raise KeyError(f"the port draws at {here[0]} {here[1]} ({callee}), a site "
                           f"with no tape key in PORTMAP.md's draw-site table")
        tape.fired.add((PORT_PACKAGE, role) + here + (callee,))
        return role, Tape.where(tape.phase_name, stack)

    def blocks(role, where, n, make):
        """One draw of ``n`` values; in a fit, one block per member."""
        if tape.phase_name != "fit":
            return make(tape.key(role, where), n)
        m = tape.members
        return np.concatenate([make(tape.key(role, where, i), n // m) for i in range(m)])

    def size_of(args, kw):
        size = kw.get("size", args[0] if args else ())
        return tuple(size) if isinstance(size, (tuple, list, torch.Size)) else (size,)

    def out(values, kw, dtype=None):
        return torch.as_tensor(values, dtype=kw.get("dtype") or dtype or torch.get_default_dtype(),
                               device=kw.get("device"))

    def rand(*args, **kw):
        role, where = lookup("rand")
        if role is None:
            return real["rand"](*args, **kw)
        shape = size_of(args, kw)
        flat = blocks(role, where, int(np.prod(shape)), lambda k, n: tape.uniform(k, (n,)))
        return out(flat.reshape(shape), kw)

    def randn(*args, **kw):
        role, where = lookup("randn")
        if role is None:
            return real["randn"](*args, **kw)
        shape = size_of(args, kw)
        flat = blocks(role, where, int(np.prod(shape)), lambda k, n: tape.normal(k, (n,)))
        return out(flat.reshape(shape), kw)

    def randint(*args, **kw):
        role, where = lookup("randint")
        if role is None:
            return real["randint"](*args, **kw)
        low, high, size = (0,) + args[:2] if len(args) == 2 else args[:3]
        shape = tuple(size)
        flat = blocks(role, where, int(np.prod(shape)),
                      lambda k, n: tape.integers(k, (n,), int(low), int(high)))
        return out(flat.reshape(shape), kw, torch.int64)

    def multinomial(weights, n, replacement=False, **kw):
        role, where = lookup("multinomial")
        if role is None:
            return real["multinomial"](weights, n, replacement, **kw)
        w = weights.detach().to("cpu", torch.float64).numpy()
        idx = blocks(role, where, n, lambda k, m: tape.categorical(k, w, m))
        return torch.as_tensor(idx, dtype=torch.int64, device=weights.device)

    for name, fn in (("rand", rand), ("randn", randn), ("randint", randint),
                     ("multinomial", multinomial)):
        monkeypatch.setattr(torch, name, fn)

    env_cls, _ = C.ENVS[env_id]
    monkeypatch.setitem(C.ENVS, env_id, (
        env_cls, lambda env, generator, size: torch.as_tensor(
            reset_pool(tape, env, size), dtype=env.dtype, device=env.device)))

    if members is not None:
        real_init = C.init_ensemble

        def init_ensemble(build, num_members, num_elites=None, device=None):
            weights = iter(members)

            def member():
                module = build().to(dtype)
                module.load_state_dict(next(weights), strict=True)
                return module

            return real_init(member, num_members, num_elites, device)

        monkeypatch.setattr(C, "init_ensemble", init_ensemble)
    if sac is not None:
        real_sac_init = C.SAC.init

        def sac_init(self, dtype_=None):
            state = real_sac_init(self, dtype)
            policy, critic = sac
            state.policy.load_state_dict(policy, strict=True)
            state.critic.load_state_dict(critic, strict=True)
            state.target.load_state_dict(critic, strict=True)
            return state

        monkeypatch.setattr(C.SAC, "init", sac_init)


def wrap_phases(ctl, tape: Tape, methods: Dict[str, str]) -> None:
    """Set the tape's phase around each of ``ctl``'s phase methods (name ->
    phase), with the iteration and, for ``imagine``, the horizon; the
    collect method draws ``warmup`` when its actions are random.  The
    iteration loop marks the end of the warmup."""
    run_iteration = ctl._run_iteration

    def loop():
        tape.in_loop = True
        return run_iteration()

    ctl._run_iteration = loop

    def wrapped(fn, phase):
        def call(*args, **kw):
            name = phase
            if phase == "collect" and (kw.get("random") or (len(args) > 1 and args[1])):
                name = "warmup"
            horizon = (kw.get("horizon", args[0] if args else None)
                       if phase == "imagine" else None)
            with tape.phase(name, tape.label(ctl.iteration), horizon):
                out = fn(*args, **kw)
                barrier = getattr(tape, "barrier", None)
                if barrier is not None:
                    barrier()
                return out

        return call

    for method, phase in methods.items():
        setattr(ctl, method, wrapped(getattr(ctl, method), phase))


PORT_PHASES = {"_collect_body": "collect", "_imagine_body": "imagine",
               "_policy_body": "policy", "evaluate_policy": "eval",
               "evaluate_surrogate": "sur_eval", "update_surrogates": "fit"}
JAX_PHASES = {"collect": "collect", "imagine": "imagine", "update_policy": "policy",
              "evaluate_policy": "eval", "evaluate_surrogate": "sur_eval",
              "update_surrogates": "fit"}


def run_port(name: str, run_dir: str, device, dtype, solver: str = "xla",
             graphs: bool = True, members=None, sac=None, reverse_sac_rows: bool = False,
             perturb: float = 0.0) -> Dict:
    """The port's ``learn()`` of the twin ``name`` (a key of ``TWINS``) on a
    fresh tape, in ``dtype`` on ``device`` through ``solver`` (KS; Burgers
    has one solver), from the port's own initialisation (seeded on the
    host, so alike on every device) or from ``members`` / ``sac`` state
    dicts.  Two perturbations for a floor of float32 rounding:
    ``reverse_sac_rows`` feeds each SAC update its batch's rows (and their
    noises) in reverse order, the same arithmetic in another summation
    order; ``perturb`` adds +-``perturb`` in turn to the points of every
    control period's field and to its rewards (a kernel's gap to the plain
    solver).  Returns the controller, the tape and what the records do not
    hold: the warmup's rewards, the first evaluation, each retrain's steps
    per member, a digest of the starting weights, and the surrogates'
    rollouts by phase, mode and whether they re-encode (``rollouts``)."""
    import pytest
    import torch

    from pdecontrol_tpu_torch.envs import burgers
    from pdecontrol_tpu_torch.mbrl.config import MBPOConfig
    from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController
    from pdecontrol_tpu_torch.models.surrogate import PDESurrogate

    config = TWINS[name].config
    tape = Tape(members=config["num_dynamics_models"])
    env_config = {**config["env_config"], "dtype": dtype}
    if config["env_id"] == "KuramotoSivashinskyEnv-v0":  # Burgers has one solver
        env_config["solver"] = solver
    cfg = MBPOConfig(**{**config, "env_config": env_config, "run_dir": run_dir})
    out: Dict = {"warmup_rewards": None, "evals": [], "fits": [], "rollouts": {}}
    with pytest.MonkeyPatch.context() as patches:
        install_port(patches, tape, config["env_id"], members, sac, dtype)
        rollout = PDESurrogate.rollout

        def counted_rollout(self, states, actions, *args, **kw):
            reencode = kw.get("reencode", args[2] if len(args) > 2 else None)
            # A rollout of one step from one state is a world step: it
            # re-encodes the previous prediction.
            again = (reencode is not None and bool(np.any(reencode))) or (
                states.shape[1] == 1 == actions.shape[1])
            key = f"{tape.phase_name} {self.mode}" + (" reencode" if again else "")
            out["rollouts"][key] = out["rollouts"].get(key, 0) + 1
            return rollout(self, states, actions, *args, **kw)

        patches.setattr(PDESurrogate, "rollout", counted_rollout)
        ctl = PDEModelBasedController(cfg, device=device, graphs=graphs)
        digest = hashlib.sha256()
        for t in [ctl.ensemble.params] + list(ctl.sac_state.policy.state_dict().values()) \
                + list(ctl.sac_state.critic.state_dict().values()):
            digest.update(t.detach().to("cpu", torch.float64).numpy().tobytes())
        out["weights_digest"] = digest.hexdigest()
        wrap_phases(ctl, tape, PORT_PHASES)

        collect, evaluate, update = (ctl._collect_body, ctl.evaluate_policy,
                                     ctl.update_surrogates)

        def collect_body(nsteps, random):
            rewards, mean = collect(nsteps, random)
            if random:
                out["warmup_rewards"] = rewards.detach().cpu().double().tolist()
            return rewards, mean

        def evaluate_policy():
            result = evaluate()
            out["evals"].append(result)
            return result

        def update_surrogates():
            before = ctl.fit_state.global_step.tolist()
            logs = update()
            out["fits"].append([b - a for a, b in
                                zip(before, ctl.fit_state.global_step.tolist())])
            return logs

        ctl._collect_body, ctl.evaluate_policy = collect_body, evaluate_policy
        ctl.update_surrogates = update_surrogates
        if reverse_sac_rows:
            real_update = ctl.sac.update

            def sac_update(state, batch, generator=None, noise=None):
                shape = tuple(batch.actions.shape)
                noise = tuple(torch.as_tensor(
                    tape.normal(tape.key("policy.noise"), (int(np.prod(shape)),)).reshape(shape),
                    dtype=dtype, device=batch.actions.device).flip(0) for _ in range(2))
                return real_update(state, batch.apply(lambda x: x.flip(0)), generator, noise)

            ctl.sac.update = sac_update
        if perturb:
            def moved(u, reward):
                sign = torch.ones_like(u)
                sign[..., 1::2] = -1
                return u + perturb * sign, reward + perturb

            if config["env_id"] == "BurgersEnv-v0":
                period = burgers.burgers_control_period
                patches.setattr(burgers, "burgers_control_period",
                                lambda *args: moved(*period(*args)))
            else:
                period = ctl.env._control_period
                object.__setattr__(ctl.env, "_control_period",
                                   lambda u, phi: moved(*period(u, phi)))
        try:
            ctl.learn()
        finally:
            ctl.logger.finish()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        out["records"] = [json.loads(line) for line in f]
    return {"ctl": ctl, "tape": tape, **out}


def gap(a, b) -> float:
    """Normwise relative gap of ``a`` from ``b``: max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.max(np.abs(b)) if b.size else 0.0
    diff = np.max(np.abs(a - b)) if b.size else 0.0
    return float(diff / scale) if scale > 0 else float(diff)


def record_gaps(records, reference) -> List[Dict[str, float]]:
    """Per iteration, each shared field's gap of ``records`` from
    ``reference``."""
    out = []
    for r, ref in zip(records, reference):
        r, ref = shared_fields(r), shared_fields(ref)
        out.append({k: gap(r[k], v) for k, v in ref.items() if k in r and k != "_step"})
    return out


def main(argv: List[str]) -> int:
    """``python tests/twin_tape.py OUT EPS [NAME]``: the port's float32 runs
    of the twin NAME (``flagship`` by default) on the host's CPU (``cpu``,
    ``cpu_reordered``, ``cpu_perturbed`` by +-EPS), each written to
    ``OUT/<name>.json``; ``chip_smoke.py`` phases 21 and 23 run it beside
    their runs on the card."""
    import torch

    sys.path.insert(0, ROOT)
    import pdecontrol_tpu_torch  # noqa: F401

    out, eps = argv[0], float(argv[1])
    twin = argv[2] if len(argv) > 2 else "flagship"
    torch.set_num_threads(1)
    runs = {"cpu": {}, "cpu_reordered": {"reverse_sac_rows": True},
            "cpu_perturbed": {"perturb": eps}}
    for name, kw in runs.items():
        result = run_port(twin, os.path.join(out, name), "cpu", torch.float32, **kw)
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump({k: v for k, v in result.items() if k not in ("ctl", "tape")}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
