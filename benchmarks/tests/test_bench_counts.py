"""The counts against hand-worked figures at small sizes, and the
convolution and linear counts against PyTorch's own FLOP counter on the
reference's networks."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks.counts import k1, peaks, sac, surrogate
from benchmarks.reference import sac as ref_sac
from benchmarks.reference import surrogate as S


def test_k1_by_hand():
    # 4 RHS x (21 taps x 2 + 8) + 10 per point and sub-step.
    assert k1.FLOPS_PER_POINT_STEP == 210
    assert k1.flops(2, 9, 3) == 2 * 9 * 3 * 210
    assert k1.bytes_moved(2, 9) == 4 * (3 * 18 + 2)
    assert k1.bound_s(10, 64, 250) == pytest.approx(10 * 64 * 250 * 210 / peaks.FP32_FLOPS)
    assert k1.is_k1("void ks_control_period_kernel<2>(float const*, float const*)")
    assert k1.is_k1("_Z32ks_control_period_general_kernelPKfS0_")
    assert not k1.is_k1("void ks_control_period_limb_kernel<2>(float const*)")
    assert not k1.is_k1("ks_control_period_limb_general_kernel")


def test_encoder_by_hand():
    # n = 8: 1->8 stride 2 (out 4): 64 + 192 + 1536; 8->16 stride 2 (out 2):
    # 512 + 1536 + 3072; 16->16 stride 1 (out 2): 1024 + 3072 + 3072.
    assert surrogate.encoder((8, 16, 16), 8) == 1792 + 5120 + 7168


def test_sac_by_hand():
    # obs 2, action 1, hidden 3: policy 2*(2*3 + 3*3) + 2*2*3*1; twin critic
    # 2 * 2*(3*3 + 3*3 + 3*1).
    assert sac.policy_forward(2, 1, 3) == 42
    assert sac.critic_forward(2, 1, 3) == 84
    assert sac.update(2, 1, 3, batch=5) == 5 * ((42 + 84) + 3 * 84 + (3 * 42 + 2 * 84))


def test_windows_by_hand():
    p = surrogate.parts(8)
    per = p["action_encoder"] + p["cell"] + p["decoder"]
    # length 6, tau 2, tbtt 3: re-encodes at t = 3; AUTOREG encodes the
    # detached output at the three other free-run steps.
    assert surrogate.train_window(8, "latent", 6, 2, 3) == 3 * (6 * per + 3 * p["encoder"])
    assert surrogate.train_window(8, "autoreg", 6, 2, 3) == (
        3 * (6 * per + 3 * p["encoder"]) + 3 * p["encoder"])
    assert surrogate.val_window(8, 6, 2) == 2 * p["encoder"] + 6 * per


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("n", [32, 64])
def test_surrogate_frame_against_the_flop_counter(n):
    torch.manual_seed(0)
    flat = torch.randn(sum(int(torch.tensor(s).prod()) for _, s in S.layout(n)))
    p = S.unflatten(flat, n)
    parts = surrogate.parts(n)
    x = torch.randn(1, 1, n)
    lat = S.encode(x, p, "state_encoder.")
    assert _counted(lambda: S.encode(x, p, "state_encoder.")) == parts["encoder"]
    assert _counted(lambda: S.encode(x, p, "action_encoder.")) == parts["action_encoder"]
    la = S.encode(x, p, "action_encoder.")
    assert _counted(lambda: S.cell((lat, lat), la, lat, True, p)) == parts["cell"]
    assert _counted(lambda: S.decode(lat, p)) == parts["decoder"]
    assert _counted(lambda: S.rollout(p, S.AUTOREG, torch.randn(1, 3, 1, n),
                                      torch.randn(1, 3, 1, n), 0.25, 0.0, 1.0)
                    ) == surrogate.teacher_forced(n, 3)


def test_sac_forward_against_the_flop_counter():
    torch.manual_seed(0)
    pp = [torch.randn(s) for s in [(8, 6), (8,), (8, 8), (8,), (3, 8), (3,), (3, 8), (3,)]]
    qp = [torch.randn(s) for s in [(8, 9), (8,), (8, 8), (8,), (1, 8), (1,)] * 2]
    obs = torch.randn(5, 1, 6)
    assert _counted(lambda: ref_sac.policy_head(pp, obs)) == 5 * sac.policy_forward(6, 3, 8)
    a = torch.randn(5, 1, 3)
    assert _counted(lambda: ref_sac.twin_q(qp, obs, a)) == 5 * sac.critic_forward(6, 3, 8)
