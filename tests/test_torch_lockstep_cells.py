"""The lock-step step against the JAX package's vmapped ``train_step`` for
the ``LSTMCell`` family (``KSAutoRegFullyConnectedLSTM``) and the
``DelayCell`` family (``KSDelayCNNSurrogateFactory``), in float64 at 1e-9:
the cases of ``tests/test_torch_lockstep.py`` for the other two cells."""

import pytest

from .test_torch_lockstep import _one_thread, check_lockstep_step  # noqa: F401


@pytest.mark.parametrize("clip", ["none", "binds_for_one"])
@pytest.mark.parametrize("factory", ["KSAutoRegFullyConnectedLSTM",
                                     "KSDelayCNNSurrogateFactory"])
def test_lockstep_step_matches_vmapped_jax_train_step(factory, clip):
    check_lockstep_step(factory, clip)
