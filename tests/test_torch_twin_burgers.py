"""The twin of ``runscripts/mbpo_burgers.sh``: the port's ``learn()`` on
``BurgersEnv-v0`` (its own env, reset pool and auto-reset; SAC's rewards
scaled by 500; no kernel) held to the JAX package's on one tape of draws,
in float64, by ``test_torch_twin.py``'s checks
(``twin_tape.TWINS["burgers"]``)."""

import pytest

from . import twin_tape as T
from .test_torch_twin import (FINAL, _one_thread, check_paths, check_record,  # noqa: F401
                              check_same_keys, check_sites_fired, twin_fixtures)

jax_side, twin = twin_fixtures("burgers")


def test_the_run_reaches_the_burgers_paths(twin):
    check_paths(twin)
    assert type(twin.ctl.env).__name__ == "Burgers"
    assert twin.ctl.sac.config.reward_scale == 500.0
    # Burgers' own draw sites fired in both packages: its resets from the
    # pool and its auto-reset.
    fired = check_sites_fired(twin)
    for pkg in (T.PORT_PACKAGE, T.JAX_PACKAGE):
        sites = {(s[1], s[2].split(".")[-1]) for s in fired[pkg] if s[1] == "envs/burgers.py"}
        assert sites == {("envs/burgers.py", "reset_from_pool"),
                         ("envs/burgers.py", "vec_step")}, (pkg, fired[pkg])


@pytest.mark.parametrize("index", range(T.TWINS["burgers"].iterations))
def test_records_agree_iteration_by_iteration(twin, index):
    check_record(twin, index)


@pytest.mark.parametrize("part", list(FINAL))
def test_final_state_agrees(twin, part):
    FINAL[part](twin)


def test_both_drew_from_the_same_keys(twin):
    check_same_keys(twin)


def test_every_draw_site_fired_has_a_tape_key(twin):
    check_sites_fired(twin)
