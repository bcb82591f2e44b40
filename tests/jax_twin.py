"""The JAX package's side of the twin (``tests/test_torch_twin.py``): its
``learn()`` of the twin NAME of ``tests/twin_tape.py`` (``flagship``,
``latent`` or ``burgers``; ``flagship`` by default) on its tape, in float64,
in a process of its own so that it overlaps the port's side:

    XLA_FLAGS=--xla_backend_optimization_level=0 python tests/jax_twin.py OUT [NAME]

Nothing of the JAX package is edited; this script patches it in memory:

  * ``jax.random.uniform``, ``normal``, ``randint`` and ``categorical``
    answer from the tape where the caller is a draw site of ``PORTMAP.md``'s
    table (and raise for a site of the package the table lacks).  The draws
    sit inside jitted scans, so a draw is an ordered
    ``jax.experimental.io_callback``: the program stays compiled and asks
    the host for each draw when it runs, in program order, and the host
    keys it by the phase the controller is in;
  * the lock-step fit's ``jax.vmap`` over members (``train/trainer.py``
    ``_member_fns``) becomes a loop over the members, traced once per
    member, so that each member's window draws carry its index (an ordered
    callback cannot be vmapped);
  * the reset pool and the starting weights come from the tape: the
    members' and the SAC networks' flax parameter trees (shapes from
    ``jax.eval_shape`` of their ``init``) in float64, kernels normal with
    variance 1 / fan-in and biases zero, with Adam states made for them.

The route is the JAX package's eager one: ``fuse_iteration=False``,
``fuse_fit=False`` and the trainer's per-batch loop (``fuse_epoch=False``:
its fused epoch carries a float32 loss that a float64 fit cannot enter).

OUT receives ``weights.npz`` (the starting flax parameters, written before
``learn()`` starts, for the port's side), the run directory ``run/`` with
``metrics.jsonl``, ``state.npz`` (the final state) and ``tape.json`` (the
keys drawn, the sites fired, the counters).
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import traverse_util  # noqa: E402
from jax.experimental import io_callback  # noqa: E402

from pdecontrol_tpu.mbrl import controller as JC  # noqa: E402
from pdecontrol_tpu.mbrl.config import MBPOConfig  # noqa: E402
from pdecontrol_tpu.models.surrogate import EnsembleState  # noqa: E402
from pdecontrol_tpu.sac import sac as JS  # noqa: E402
from pdecontrol_tpu.train import trainer as JT  # noqa: E402
from tests import twin_tape as T  # noqa: E402

TAPE = T.Tape()  # main() sets the members of its twin
TAPE.barrier = jax.effects_barrier
MEMBERS = [False]  # whether a vmap over the members is tracing


def _array(x) -> bool:
    return isinstance(x, (jax.Array, np.ndarray, np.generic))


def _host(callee, role, where, members, args, kw, struct):
    """The host's answer to one draw: the tape's values in the real draw's
    shape and dtype."""
    shape, dtype = struct.shape, np.dtype(struct.dtype)

    def answer(_key, *operands):
        ops = iter(operands)
        vals = [next(ops) if _array(a) else a for a in args[1:]]
        key = TAPE.member_key(role, where) if members else TAPE.key(role, where)
        if callee == "uniform":
            lo = kw.get("minval", vals[2] if len(vals) > 2 else 0.0)
            hi = kw.get("maxval", vals[3] if len(vals) > 3 else 1.0)
            u = TAPE.uniform(key, shape)
            out = u if (lo, hi) == (0.0, 1.0) else u * (float(hi) - float(lo)) + float(lo)
        elif callee == "normal":
            out = TAPE.normal(key, shape)
        elif callee == "randint":
            lo, hi = (kw.get("minval", vals[1]), kw.get("maxval", vals[2]))
            out = TAPE.integers(key, shape, int(lo), int(hi))
        else:  # categorical over the last axis
            out = TAPE.categorical(key, np.exp(np.asarray(vals[0], np.float64)),
                                   int(np.prod(shape)))
        return np.asarray(out, dtype).reshape(shape)

    return answer


def _shim(callee):
    real = getattr(jax.random, callee)
    index = T.site_index(T.JAX_PACKAGE)

    def draw(*args, **kw):
        here, stack = T.caller(1, T.JAX_PACKAGE)
        if here is None:
            return real(*args, **kw)
        role = index.get(here + (callee,))
        if role is None:
            raise KeyError(f"the JAX package draws at {here[0]} {here[1]} ({callee}), a "
                           f"site with no tape key in PORTMAP.md's draw-site table")
        TAPE.fired.add((T.JAX_PACKAGE, role) + here + (callee,))
        where = T.Tape.where(TAPE.phase_name, stack)
        arrays = [i for i, a in enumerate(args) if _array(a)]

        def abstract(*xs):
            full = list(args)
            for i, x in zip(arrays, xs):
                full[i] = x
            return real(*full, **kw)

        struct = jax.eval_shape(abstract, *(args[i] for i in arrays))
        # The key goes along although the host ignores it: under the members'
        # vmap it is the operand that is batched, so that JAX calls the
        # callback once per member, in order (``lax.map``), and the host
        # counts the members off.
        operands = [a for a in args if _array(a)]
        return io_callback(_host(callee, role, where, MEMBERS[0], args, kw, struct), struct,
                           *operands, ordered=not MEMBERS[0])

    return draw


class _MembersVmap:
    """The trainer's ``jax``, whose ``vmap`` over the members marks what it
    traces, so that a draw there is an unordered callback (an ordered one
    cannot be vmapped)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def vmap(fn, in_axes=0):
        mapped = jax.vmap(fn, in_axes=in_axes)

        def call(*args):
            MEMBERS[0] = True
            try:
                return mapped(*args)
            finally:
                MEMBERS[0] = False

        return call


def _tape_params(abstract, name):
    """Float64 parameters of a flax parameter tree's shapes from the tape: a
    kernel's entries normal with variance 1 / fan-in, biases zero.  They
    stay numpy arrays until a program takes them (an eager JAX operation on
    each leaf would compile a program per shape)."""
    flat = traverse_util.flatten_dict(abstract, sep="/")
    out = {}
    for path, leaf in flat.items():
        shape = tuple(leaf.shape)
        if len(shape) < 2:
            out[path] = np.zeros(shape)
        else:
            out[path] = TAPE.normal(("weights", name, path), shape) / np.sqrt(np.prod(shape[:-1]))
    return traverse_util.unflatten_dict(out, sep="/")


def _init_ensemble(module, key, num_members, example_states, example_actions,
                   num_elites=None):
    abstract = jax.eval_shape(module.init, key, example_states, example_actions)["params"]
    params = [_tape_params(abstract, f"member{i}") for i in range(num_members)]
    return EnsembleState(params=jax.tree.map(lambda *p: np.stack(p), *params),
                         elite_mask=jnp.ones((num_members,), bool),
                         num_elites=num_elites or num_members)


def _sac_init(sac, key):
    """``SAC.init`` with float64 networks from the tape."""
    obs = jnp.zeros((1,) + sac.obs_shape)
    act = jnp.zeros((1,) + sac.action_shape)
    policy = _tape_params(jax.eval_shape(sac.policy.init, key, obs)["params"], "policy")
    critic = _tape_params(jax.eval_shape(sac.critic.init, key, obs, act)["params"], "critic")
    log_alpha = jnp.zeros((), jnp.float64)
    return JS.SACState(policy_params=policy, critic_params=critic,
                       target_params=jax.tree.map(np.copy, critic),
                       policy_opt=sac.optimizer.init(policy),
                       critic_opt=sac.optimizer.init(critic), log_alpha=log_alpha,
                       alpha_opt=sac.optimizer.init(log_alpha),
                       updates=jnp.zeros((), jnp.int32), config=sac.config)


def _flat(prefix, tree):
    return {f"{prefix}/{k}": np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def _adam(opt_state):
    (adam,) = [s for s in opt_state if hasattr(s, "mu")]
    return adam


def main(out, name="flagship"):
    config = T.TWINS[name].config
    TAPE.members = config["num_dynamics_models"]
    for callee in ("uniform", "normal", "randint", "categorical"):
        setattr(jax.random, callee, _shim(callee))
    JT.jax = _MembersVmap()
    JC.init_ensemble = _init_ensemble
    JS.SAC.init = _sac_init
    env_cls, _ = JC.ENVS[config["env_id"]]
    JC.ENVS[config["env_id"]] = (env_cls, lambda env, key, size: jnp.asarray(
        T.reset_pool(TAPE, env, size), env.dtype))

    cfg = MBPOConfig(**{**config, "env_config": {**config["env_config"],
                                                 "dtype": jnp.float64},
                        "run_dir": os.path.join(out, "run"),
                        "fuse_iteration": False, "fuse_fit": False})
    ctl = JC.PDEModelBasedController(cfg)
    ctl.trainer.fuse_epoch = False
    policy, critic = ctl.sac_state.policy_params, ctl.sac_state.critic_params
    weights = {**_flat("policy", policy), **_flat("critic", critic)}
    for i in range(cfg.num_dynamics_models):
        weights.update(_flat(f"member{i}", jax.tree.map(lambda x: x[i], ctl.ensemble.params)))
    np.savez(os.path.join(out, "weights.tmp.npz"), **weights)
    os.replace(os.path.join(out, "weights.tmp.npz"), os.path.join(out, "weights.npz"))

    T.wrap_phases(ctl, TAPE, T.JAX_PHASES)
    ctl.learn()
    ctl.logger.finish()

    s = ctl.sac_state
    state = {**_flat("sac/policy", s.policy_params), **_flat("sac/critic", s.critic_params),
             **_flat("sac/target", s.target_params)}
    for name in ("policy", "critic"):
        adam = _adam(getattr(s, f"{name}_opt"))
        state.update(_flat(f"sac/{name}_mu", adam.mu))
        state.update(_flat(f"sac/{name}_nu", adam.nu))
        state[f"sac/{name}_count"] = np.asarray(adam.count)
    state["sac/log_alpha"] = np.asarray(s.log_alpha)
    state["sac/updates"] = np.asarray(s.updates)
    members = jax.tree.map(lambda *xs: jnp.stack(xs), *ctl.member_states)
    adam = _adam(members.opt_state)
    state.update(_flat("members/params", members.params))
    state.update(_flat("members/mu", adam.mu))
    state.update(_flat("members/nu", adam.nu))
    state["members/count"] = np.asarray(adam.count)
    state["members/global_step"] = np.asarray(members.global_step)
    state.update(_flat("ensemble", ctl.ensemble.params))
    state["elite_mask"] = np.asarray(ctl.ensemble.elite_mask)
    for name in ("replay", "world_replay"):
        rep = getattr(ctl, name)
        for f in ("obs_seq", "actions", "rewards", "terminated", "truncated", "steps", "fill",
                  "complete", "row_of_env", "next_row", "total_steps"):
            state[f"{name}/{f}"] = np.asarray(getattr(rep, f))
    state["oscaling/vmin"] = np.asarray(ctl.tr.oscaling.vmin)
    state["oscaling/vmax"] = np.asarray(ctl.tr.oscaling.vmax)
    for f in ("mean", "var", "count"):
        state[f"undscaling/{f}"] = np.asarray(getattr(ctl.tr.undscaling, f))
    state["env/u"] = np.asarray(ctl.env_state.u)
    state["env/step"] = np.asarray(ctl.env_state.step)
    np.savez(os.path.join(out, "state.npz"), **state)
    with open(os.path.join(out, "tape.json"), "w") as f:
        json.dump({"keys": [list(k) for k in TAPE.keys],
                   "fired": sorted(list(s) for s in TAPE.fired),
                   "iteration": ctl.iteration, "num_pol_updates": ctl.num_pol_updates,
                   "num_ensemble_updates": ctl.num_ensemble_updates}, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
