"""The twin of ``runscripts/mbpo_ks_latent_r4.sh``: the port's ``learn()``
of the latent family (``KSLatentConvolutionalLSTM`` in LATENT mode: encode,
step in the latent, decode; each world step re-encodes the previous
prediction; the fit's loss on the decoded states) held to the JAX
package's on one tape of draws, in float64, by ``test_torch_twin.py``'s
checks (``twin_tape.TWINS["latent"]``)."""

import pytest

from pdecontrol_tpu_torch.models.surrogate import LATENT

from . import twin_tape as T
from .test_torch_twin import (FINAL, _one_thread, check_paths, check_record,  # noqa: F401
                              check_same_keys, check_sites_fired, twin_fixtures)

# The latent family's rollouts run longer than they compile at XLA's lowest
# optimisation; its first level takes the JAX side ~10% less time.
jax_side, twin = twin_fixtures("latent", "--xla_backend_optimization_level=1")


def test_the_run_reaches_the_latent_paths(twin):
    check_paths(twin)
    assert all(m.mode == LATENT for m in twin.ctl.ensemble.members)
    # World steps re-encode, in every imagine phase's rollouts; the fit's
    # TBPTT windows self-force at their chunk boundaries.
    assert twin.rollouts.get(f"imagine {LATENT} reencode", 0) > 0, twin.rollouts
    assert twin.rollouts.get(f"fit {LATENT} reencode", 0) > 0, twin.rollouts


@pytest.mark.parametrize("index", range(T.TWINS["latent"].iterations))
def test_records_agree_iteration_by_iteration(twin, index):
    check_record(twin, index)


@pytest.mark.parametrize("part", list(FINAL))
def test_final_state_agrees(twin, part):
    FINAL[part](twin)


def test_both_drew_from_the_same_keys(twin):
    check_same_keys(twin)


def test_every_draw_site_fired_has_a_tape_key(twin):
    check_sites_fired(twin)
