"""Kernels K1 and K2 on an NVIDIA card: built from the checkout, launched,
and held to their plain PyTorch versions (K1 float32 at the tolerance of
tests/test_pallas_ks.py over 20 sub-steps, rtol 1e-4 / atol 1e-5 over a
full period of 250; K2's limb modes at rtol 1e-4 / atol 1e-4, the
tolerance of tests/test_torch_packed.py against the JAX kernel body, over
20 sub-steps and, at 3 and 4 passes, over a full period).  Both kernels run
one warp per row with the state in registers, so the cases cover every
batch shape the main path launches (1 to 1024 rows) and grids of 32, 64
and 128 points (1, 2 and 4 points per lane), and K2 also 96 and 256 (3 and
8 points per lane).  A group holds a checkpoint's round trip on the
card: bit-equal tensors that come back on the card, a generator that goes on
with the saved stream, and a resumed run that learns on.  The next holds the
fused iteration's CUDA graph to its eager body: a capture that leaves the
generator and the counters as they were, a replay equal to the eager
iteration in every tensor and record field, launch counts that see the
replay, a body that waits for nothing on the host, and two horizons' graphs
in one pool.  Then the lock-step fit of the members: replayed from its
graphs it equals the eager fit bit for bit, a capture leaves the state and
the generator as they were, and a rebound parameter makes a replay raise.
The group after it
holds each surrogate family's rollout and a Burgers control period on the
card to the same computation on the CPU (rtol 3e-5, atol 3e-6, the float32
tolerance of tests/test_env_solvers.py).  The last group runs two rank
processes of a mesh, on one card through gloo and with a card each through
NCCL: a gather, the sharded collect through K1 and a data-parallel SAC
update, and under NCCL ``Mesh.mean_`` and ``Mesh.gather`` replayed from a
CUDA graph; beside it, one NCCL rank's ``all_reduce`` captured on one card.  Every test here
needs a card
and skips without one.  This file imports no JAX, so that it runs where JAX
is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import pdecontrol_tpu_torch  # noqa: F401  (turns TF32 off)

    return torch.device("cuda")


def _k1_inputs(dev, batch, n, seed):
    """K1's operators (the flagship's grid spacing, L = 22 at 64 points, so
    that dt = 1e-3 stays stable at every n) and a random state under a
    sine forcing."""
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    ops = KSOperators.create(n, 22.0 * n / 64, device=dev)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32, device=dev)
    phi = torch.as_tensor(np.repeat(0.3 * np.sin(2 * np.pi * np.arange(n) / n)[None],
                                    batch, 0), dtype=torch.float32, device=dev)
    return ops, u, phi


@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("batch", [1, 3, 10, 64, 1024])
def test_kernel_matches_plain_version(dev, objective, n, batch):
    """The plain version runs on the CPU here.  The upwind u_x switches
    between two one-sided stencils on the sign of each stage value, so a
    last-bit difference in a value near 0 moves u by ~1e-6.  At batch 1024
    on 128 points the plain version on the card (cuBLAS sums the
    ``[u | u^2] @ W`` product in its own order) crossed that switch at one
    point (u = -0.0043, off by 2.4e-6) where the kernel and the plain
    version on the CPU agree to 3e-7 everywhere (NVIDIA H100 80GB HBM3)."""
    from pdecontrol_tpu_torch.ops import pallas_ks

    ops, u, phi = _k1_inputs(dev, batch, n, batch)
    before = pallas_ks.launch_count
    got = pallas_ks.ks_control_period(ops, u, phi, 1e-3, 20, objective)
    torch.cuda.synchronize()
    assert pallas_ks.launch_count == before + 1
    ref = pallas_ks.ks_control_period_plain(ops, u.cpu(), phi.cpu(), 1e-3, 20, objective)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
def test_kernel_matches_plain_version_over_a_full_period(dev, objective):
    """250 sub-steps at the reset pool's batch: the reward's float32 sum runs
    in another order (per lane over the period, then over the row), and
    the state's error grows over the period."""
    from pdecontrol_tpu_torch.ops import pallas_ks

    ops, u, phi = _k1_inputs(dev, 64, 64, 7)
    got = pallas_ks.ks_control_period(ops, u, phi, 1e-3, 250, objective)
    ref = pallas_ks.ks_control_period_plain(ops, u, phi, 1e-3, 250, objective)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)


def test_kernel_wrapper_raises_instead_of_falling_back(dev):
    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    ops = KSOperators.create(64, 22.0, device=dev)
    u64 = torch.zeros(4, 64, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        pallas_ks.ks_control_period(ops, u64, u64, 1e-3, 2)
    strided = torch.zeros(64, 8, device=dev).t()
    with pytest.raises(ValueError):
        pallas_ks.ks_control_period(ops, strided, strided, 1e-3, 2)
    ops32 = KSOperators.create(48, 22.0, device=dev)  # not a multiple of 32
    u = torch.zeros(2, 48, device=dev)
    with pytest.raises(RuntimeError):
        pallas_ks.ks_control_period(ops32, u, u, 1e-3, 2)


def _k2_inputs(dev, batch, n, seed):
    """K2's operators at the flagship spacing and a smooth field under a
    sine forcing.  Smooth fields, as on the attractor: on rough ones the
    derivatives are large enough that a last-bit difference in the
    summation order flips the bf16 rounding of an operand within 20
    sub-steps, and one flip moves one-pass bf16 by ~1e-3 (the limb modes
    absorb it in the lo limb)."""
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    ops = KSOperators.create(n, 22.0 * n / 64, device=dev)
    rng = np.random.default_rng(seed)
    f = np.fft.rfft(rng.normal(size=(batch, n)), axis=-1)
    f[:, 8:] = 0
    field = np.fft.irfft(f, n=n, axis=-1)
    u = torch.as_tensor(3.0 * field / np.abs(field).max(), dtype=torch.float32, device=dev)
    phi = torch.as_tensor(np.repeat(0.3 * np.sin(2 * np.pi * np.arange(n) / n)[None],
                                    batch, 0), dtype=torch.float32, device=dev)
    return ops, u, phi


@pytest.mark.parametrize("precision", ["bf16", "bf16_3x", "bf16_4x"])
@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
@pytest.mark.parametrize("n, batch", [(64, 1), (64, 3), (64, 8), (64, 10), (64, 12),
                                      (64, 64), (64, 1024), (32, 8), (96, 8), (128, 8),
                                      (256, 8)])
def test_limb_kernel_matches_plain_version(dev, precision, objective, n, batch):
    """Every halo case of the lanes' shuffles: 1 point per lane (n = 32, the
    halo up to four lanes away), 2 and 3 (n = 64, 96: one or two lanes
    away), and 4 to 8 (n = 128, 256: the next lane only), the last with the
    most registers."""
    from pdecontrol_tpu_torch.ops import pallas_ks_packed

    ops, u, phi = _k2_inputs(dev, batch, n, batch)
    before = pallas_ks_packed.launch_count
    got = pallas_ks_packed.ks_control_period_packed(ops, u, phi, 1e-3, 20, objective,
                                                    precision)
    torch.cuda.synchronize()
    assert pallas_ks_packed.launch_count == before + 1
    ref = pallas_ks_packed.ks_control_period_packed_plain(ops, u, phi, 1e-3, 20, objective,
                                                          precision)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("precision", ["bf16_3x", "bf16_4x"])
@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
def test_limb_kernel_matches_plain_version_over_a_full_period(dev, precision, objective):
    """250 sub-steps at the reset pool's batch.  One-pass bf16 is not held
    this long: its rounding flips add up over a period."""
    from pdecontrol_tpu_torch.ops import pallas_ks_packed

    ops, u, phi = _k2_inputs(dev, 64, 64, 7)
    got = pallas_ks_packed.ks_control_period_packed(ops, u, phi, 1e-3, 250, objective,
                                                    precision)
    ref = pallas_ks_packed.ks_control_period_packed_plain(ops, u, phi, 1e-3, 250, objective,
                                                          precision)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


def test_limb_kernel_highest_is_k1_and_odd_env_batches_skip_k2(dev):
    from pdecontrol_tpu_torch.envs.kuramoto import EnvState, KuramotoSivashinsky
    from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    ops = KSOperators.create(64, 22.0, device=dev)
    u = torch.zeros(4, 64, device=dev)
    k1, k2 = pallas_ks.launch_count, pallas_ks_packed.launch_count
    pallas_ks_packed.ks_control_period_packed(ops, u, u, 1e-3, 2, precision="highest")
    torch.cuda.synchronize()
    assert (pallas_ks.launch_count, pallas_ks_packed.launch_count) == (k1 + 1, k2)

    env = KuramotoSivashinsky.create(cfg_steps=5, solver="pallas_packed",
                                     pallas_precision="bf16_3x", device=dev)
    for shape, launched in (((7,), 0), ((), 0), ((8,), 1)):
        state = EnvState(u=torch.zeros(shape + (64,), device=dev),
                         step=torch.zeros(shape, dtype=torch.int32, device=dev))
        k2 = pallas_ks_packed.launch_count
        env.step(state, torch.zeros(shape + (1, 4), device=dev))
        torch.cuda.synchronize()
        assert pallas_ks_packed.launch_count == k2 + launched, shape


def test_limb_kernel_wrapper_raises_instead_of_falling_back(dev):
    from pdecontrol_tpu_torch.ops import pallas_ks_packed
    from pdecontrol_tpu_torch.ops.kuramoto import KSOperators

    ops = KSOperators.create(64, 22.0, device=dev)
    u64 = torch.zeros(4, 64, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        pallas_ks_packed.ks_control_period_packed(ops, u64, u64, 1e-3, 2, precision="bf16_3x")
    strided = torch.zeros(64, 8, device=dev).t()
    with pytest.raises(ValueError):
        pallas_ks_packed.ks_control_period_packed(ops, strided, strided, 1e-3, 2,
                                                  precision="bf16_3x")
    ops48 = KSOperators.create(48, 22.0, device=dev)  # not a multiple of 32
    u = torch.zeros(2, 48, device=dev)
    before = pallas_ks_packed.launch_count
    with pytest.raises(RuntimeError):
        pallas_ks_packed.ks_control_period_packed(ops48, u, u, 1e-3, 2, precision="bf16_3x")
    assert pallas_ks_packed.launch_count == before


# ------------------------------------------------------ checkpoint and resume
def _tiny_controller(run_dir, *flags, device=None, graphs=True):
    """The MBPO controller at a tiny size (32 grid points: one point per lane
    of K1; 8-step episodes; 2 envs), on the card unless told otherwise."""
    import json

    from pdecontrol_tpu_torch.mbrl import script
    from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController

    args = [
        "--env_config", json.dumps({"n": 32, "cfg_steps": 5, "t_max": 0.04,
                                    "transient_time": 0.5}),
        "--num_envs", "2", "--total_timesteps", "16", "--learning_starts", "8",
        "--pool_size", "8", "--surrogate_train_freq", "8", "--capacity", "256",
        "--model_buffer_max_capacity", "64", "--model_buffer_store_iterations", "2",
        "--policy_train_steps_per_sample", "1", "--model_rollouts_per_sample", "2",
        "--model_rollouts_batch_size", "4", "--num_dynamics_models", "2",
        "--policy_batch_size", "8", "--agent_eval_freq", "4", "--num_eval_episodes", "2",
        "--surrogate_eval_horizon", "4", "--solver", "pallas", "--logging_freq", "0",
        "--rollout_length_schedule", json.dumps({"scheduler": "ConstantLengthScheduler",
                                                 "length": 2}),
        "--training", json.dumps({"tau": 2, "initial": {"tbtt": 4, "patience": 2,
                                                        "batch_size": 4},
                                  "iterations": {"tbtt": 4, "patience": 1, "batch_size": 4}}),
        "--trainer", json.dumps({"initial": {"min_steps": 2, "max_steps": 6},
                                 "iterations": {"min_steps": 1, "max_steps": 3}}),
        "--curriculum", json.dumps({"scheduler": "ConstantLengthScheduler", "length": 3}),
        "--run_dir", str(run_dir), "--checkpoint_freq", "2", *flags,
    ]
    config = script.config_from_args(script.build_parser().parse_args(args))
    return PDEModelBasedController(config, device=device, graphs=graphs)


def _tensors(tree, path="state"):
    """Every ``(path, tensor)`` of a nested snapshot."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}[{i}]")


@pytest.fixture
def stopped_and_resumed(dev, tmp_path):
    """A run of 4 iterations on the card, stopped, and a new controller
    built with ``--resume`` on its run directory."""
    ctl = _tiny_controller(tmp_path / "run")
    try:
        ctl.learn()
    finally:
        ctl.logger.finish()
    resumed = _tiny_controller(tmp_path / "run", "--resume", "--total_timesteps", "20")
    yield ctl, resumed
    resumed.logger.finish()


def test_checkpoint_roundtrip_on_the_card_is_bit_equal(stopped_and_resumed):
    from pdecontrol_tpu_torch.utils import checkpoint as C

    ctl, resumed = stopped_and_resumed
    assert ctl.iteration == 4 and resumed.restored and resumed.iteration == 4
    saved = dict(_tensors(C.controller_state(ctl)))
    back = dict(_tensors(C.controller_state(resumed)))
    assert saved.keys() == back.keys() and len(saved) > 50
    for path, t in saved.items():
        assert back[path].dtype == t.dtype and back[path].device == t.device, path
        assert torch.equal(back[path], t), path


def test_restored_tensors_live_on_the_card(stopped_and_resumed):
    """All but what PyTorch itself keeps on the host: a generator's state
    and the step counters of the surrogates' Adam.  SAC's Adam is
    capturable on the card, so its counters live there too."""
    from pdecontrol_tpu_torch.utils import checkpoint as C

    _, resumed = stopped_and_resumed
    for path, t in _tensors(C.controller_state(resumed)):
        on_host = path == "state['generator']" or (
            path.startswith("state['member_states']") and path.endswith("['step']"))
        assert t.device.type == ("cpu" if on_host else "cuda"), path
    assert resumed.gen.device.type == "cuda"
    for p in resumed.sac_state.policy.parameters():
        assert p.device.type == "cuda"


def test_restored_generator_continues_the_saved_stream(stopped_and_resumed):
    ctl, resumed = stopped_and_resumed
    for shape in ((3,), (2, 5), (1,)):
        a = torch.rand(shape, generator=ctl.gen, device="cuda")
        b = torch.rand(shape, generator=resumed.gen, device="cuda")
        assert torch.equal(a, b)
    assert torch.equal(torch.randint(0, 1000, (7,), generator=ctl.gen, device="cuda"),
                       torch.randint(0, 1000, (7,), generator=resumed.gen, device="cuda"))


def test_resumed_run_goes_on_learning_on_the_card(stopped_and_resumed, tmp_path):
    import json

    from pdecontrol_tpu_torch.ops import pallas_ks

    _, resumed = stopped_and_resumed
    before = pallas_ks.launch_count
    resumed.learn()
    assert resumed.iteration == 6 and resumed.ckpt.latest_step() == 6
    assert pallas_ks.launch_count > before
    records = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert [r["iteration"] for r in records] == list(range(6))
    assert "t_warmup_collect" not in records[4]


# ------------------------------------------- the fused iteration as a graph
@pytest.fixture
def graphed_and_eager(dev, tmp_path):
    """Two controllers at one state after the warm-up and iteration 0 (a
    retrain, eager): ``graphed`` captures iteration 1 as a CUDA graph and
    replays it, ``eager`` runs the same body eagerly.  Returns both and
    what the capture left behind."""
    from pdecontrol_tpu_torch.ops import pallas_ks
    from pdecontrol_tpu_torch.utils import checkpoint as C

    flags = ("--checkpoint_freq", "0", "--total_timesteps", "10")
    graphed = _tiny_controller(tmp_path / "graphed", *flags)
    graphed.learn()  # the warm-up and iteration 0
    eager = _tiny_controller(tmp_path / "eager", *flags)
    C.load_controller_state(eager, C.to_host(C.controller_state(graphed)))

    gen, counters = graphed.gen.get_state(), (graphed.num_pol_updates,
                                              graphed.sac_state.updates)
    launches = pallas_ks.launch_count
    graphed._prepare_graph()
    capture = {"gen": (gen, graphed.gen.get_state()),
               "counters": (counters, (graphed.num_pol_updates, graphed.sac_state.updates)),
               "launches": (launches, pallas_ks.launch_count)}
    assert graphed.graphs.get(graphed._fused_key()) is not None
    assert eager.graphs.get(eager._fused_key()) is None and not eager._warm

    replayed = {}
    for name, ctl in (("graphed", graphed), ("eager", eager)):
        before = pallas_ks.launch_count
        ctl._run_iteration()
        ctl._flush_pending_log()
        torch.cuda.synchronize()
        replayed[name] = pallas_ks.launch_count - before
    yield graphed, eager, capture, replayed
    graphed.logger.finish()
    eager.logger.finish()


def test_capture_leaves_the_generator_and_the_counters_unchanged(graphed_and_eager):
    _, _, capture, _ = graphed_and_eager
    before, after = capture["gen"]
    assert torch.equal(before, after)
    assert capture["counters"][0] == capture["counters"][1]
    assert capture["launches"][0] == capture["launches"][1]


def test_graphed_iteration_equals_the_eager_one(graphed_and_eager):
    """Replay, world replay, SAC parameters, Adam moments and step counters,
    transforms, env state, the generator after and every non-clock field
    of the record: all exactly equal."""
    import json

    from pdecontrol_tpu_torch.utils import checkpoint as C

    graphed, eager, _, _ = graphed_and_eager
    assert graphed.iteration == eager.iteration == 2
    a = dict(_tensors(C.controller_state(graphed)))
    b = dict(_tensors(C.controller_state(eager)))
    assert a.keys() == b.keys()
    for path, t in a.items():
        assert torch.equal(t, b[path]), path
    assert (graphed.num_pol_updates, graphed.sac_state.updates) == \
        (eager.num_pol_updates, eager.sac_state.updates)

    def record(ctl):
        r = [json.loads(line) for line in open(f"{ctl.config.run_dir}/metrics.jsonl")][-1]
        return {k: v for k, v in r.items()
                if not k.startswith(("t_", "_")) and k not in ("time", "env_steps_per_sec",
                                                                "graph_pool_mb")}

    assert record(graphed) == record(eager)
    assert record(graphed)["iteration"] == 1


def test_replay_counts_the_launches_it_makes(graphed_and_eager):
    """K1's count goes up by the captured launches at the replay (one
    collect step), as the eager iteration's does."""
    _, _, _, replayed = graphed_and_eager
    assert replayed == {"graphed": 1, "eager": 1}


def test_fused_body_waits_for_nothing_on_the_host(graphed_and_eager):
    """One eager pass of the body under the sync debug mode: no operation
    of collect, imagine, the SAC updates or the packing synchronises."""
    _, eager, _, _ = graphed_and_eager
    key = eager._fused_key()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = eager._fused_body(key[0], key[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert packed.shape == (6,) and bool(torch.isfinite(packed).all())


def test_graphs_of_two_horizons_share_one_pool(dev, tmp_path):
    """Horizons 2, 3 and 2 again at iterations 1–3: two graphs captured into
    one memory pool, the first replayed after the second's capture, equal
    to the eager phases in every tensor and record field."""
    import json

    from pdecontrol_tpu_torch.utils import checkpoint as C

    schedule = json.dumps({"scheduler": "StepScheduler", "steptype": "iteration",
                           "steps": [1, 2], "values": [2, 3, 2]})
    flags = ("--checkpoint_freq", "0", "--total_timesteps", "10",
             "--rollout_length_schedule", schedule)
    graphed = _tiny_controller(tmp_path / "graphed", *flags)
    graphed.learn()  # the warm-up and iteration 0
    eager = _tiny_controller(tmp_path / "eager", *flags, "--no_fuse_iteration", graphs=False)
    C.load_controller_state(eager, C.to_host(C.controller_state(graphed)))
    try:
        for ctl in (graphed, eager):
            for _ in range(3):
                ctl._run_iteration()
            ctl._flush_pending_log()
        # The fused iteration's keys are (rollout length, horizon, rounds, updates).
        horizons = [key[1] for key in graphed.graphs.graphs if isinstance(key[0], int)]
        assert sorted(horizons) == [2, 3]
        assert eager.graphs is None
        a = dict(_tensors(C.controller_state(graphed)))
        b = dict(_tensors(C.controller_state(eager)))
        for path, t in a.items():
            assert torch.equal(t, b[path]), path

        def records(ctl):
            with open(f"{ctl.config.run_dir}/metrics.jsonl") as f:
                rs = [json.loads(line) for line in f][-3:]
            return [{k: v for k, v in r.items() if not k.startswith(("t_", "_"))
                     and k not in ("time", "env_steps_per_sec", "graph_pool_mb")}
                    for r in rs]

        assert [r["horizon"] for r in records(graphed)] == [2, 3, 2]
        assert records(graphed) == records(eager)
    finally:
        graphed.logger.finish()
        eager.logger.finish()


# ------------------------------------------- the lock-step fit as graphs
FIT_GRAPHS = ("fit_step", "fit_val")


def _fit_state(ctl):
    st = ctl.fit_state
    return {"params": st.params, "exp_avg": st.exp_avg, "exp_avg_sq": st.exp_avg_sq,
            "count": st.count, "global_step": st.global_step}


@pytest.fixture
def fitted(dev, tmp_path):
    """Three members of a tiny controller after the warm-up and iteration 0
    (its retrain captured the fit's two graphs), and a controller with
    ``--no_fuse_fit`` loaded with the same state; both retrain once more."""
    from pdecontrol_tpu_torch.utils import checkpoint as C

    flags = ("--checkpoint_freq", "0", "--total_timesteps", "10",
             "--num_dynamics_models", "3", "--num_elite_models", "2")
    graphed = _tiny_controller(tmp_path / "graphed", *flags)
    graphed.learn()
    assert {key[0] for key in graphed.graphs.graphs} >= set(FIT_GRAPHS)
    eager = _tiny_controller(tmp_path / "eager", *flags, "--no_fuse_fit")
    C.load_controller_state(eager, C.to_host(C.controller_state(graphed)))
    yield graphed, eager
    graphed.logger.finish()
    eager.logger.finish()


def test_graphed_fit_equals_the_eager_fit(fitted):
    """The same retrain replayed from the graphs and run eagerly: parameters,
    Adam moments and counts, global steps, val losses, steps, epochs and
    the generator after it, all exactly equal."""
    graphed, eager = fitted
    captured = len(graphed.graphs.graphs)
    logs = {}
    for name, ctl in (("graphed", graphed), ("eager", eager)):
        ctl.update_delta_transform()
        logs[name] = ctl.update_surrogates()
        torch.cuda.synchronize()
    assert len(graphed.graphs.graphs) == captured and not eager.graphs.graphs
    assert "t_fit_ready" in logs["graphed"] and "t_fit_val" in logs["eager"]
    for k in ("val_loss", "train_loss", "elite_scores", "steps", "epochs", "lr"):
        assert logs["graphed"][k] == logs["eager"][k], k
    a, b = _fit_state(graphed), _fit_state(eager)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(a["count"].min()) > 0
    assert torch.equal(graphed.gen.get_state(), eager.gen.get_state())
    for p, q in zip(graphed.ensemble.members.parameters(), eager.ensemble.members.parameters()):
        assert torch.equal(p, q)


def test_fit_capture_leaves_the_state_and_the_generator(dev, tmp_path):
    """Each of the fit's captures (its step and its validation step, at the
    first retrain) launches nothing: the stacked state and the generator
    are as they were before it."""
    ctl = _tiny_controller(tmp_path / "run", "--checkpoint_freq", "0",
                           "--total_timesteps", "10")
    real, seen = ctl.graphs.capture, []

    def spy(key, body, state):
        torch.cuda.synchronize()
        before = ({k: v.clone() for k, v in _fit_state(ctl).items()}, ctl.gen.get_state())
        graph = real(key, body, state)
        torch.cuda.synchronize()
        # Copies: the later replays write the live tensors.
        after = {k: v.clone() for k, v in _fit_state(ctl).items()}
        seen.append((key, before, (after, ctl.gen.get_state())))
        return graph

    ctl.graphs.capture = spy
    try:
        ctl.learn()
    finally:
        ctl.logger.finish()
    assert {key[0] for key, _, _ in seen} >= set(FIT_GRAPHS)
    for key, (state, gen), (state_after, gen_after) in seen:
        if key[0] in FIT_GRAPHS:
            assert torch.equal(gen, gen_after), key
            for k in state:
                assert torch.equal(state[k], state_after[k]), (key, k)


def test_fit_replay_after_a_rebound_parameter_raises(fitted):
    """A graph reads the parameters at their addresses: a member whose
    parameter was rebound to a new tensor makes the next replay raise."""
    graphed, _ = fitted
    cell = graphed.ensemble.members[1].cell
    cell.wx.weight = torch.nn.Parameter(cell.wx.weight.detach().clone())
    with pytest.raises(RuntimeError, match="replaying the surrogate fit's fit_step"):
        graphed.update_surrogates()


# ------------------------- the phases, evaluations, SAC chunk, fit and gate
def _same_state(a, b, label):
    """Every tensor of two controllers' snapshots (networks, Adam state,
    replays, transforms, env state, generator) is equal, as are the host
    counters."""
    from pdecontrol_tpu_torch.utils import checkpoint as C

    sa, sb = dict(_tensors(C.controller_state(a))), dict(_tensors(C.controller_state(b)))
    assert sa.keys() == sb.keys()
    for path, t in sa.items():
        assert torch.equal(t, sb[path]), (label, path)
    assert (a.num_pol_updates, a.sac_state.updates) == (b.num_pol_updates, b.sac_state.updates)


def _same(x, y, label):
    if isinstance(x, dict):
        assert x.keys() == y.keys(), label
        for k in x:
            _same(x[k], y[k], (label, k))
    elif isinstance(x, (tuple, list)):
        for i, (p, q) in enumerate(zip(x, y)):
            _same(p, q, (label, i))
    elif isinstance(x, torch.Tensor):
        assert torch.equal(x, y), label
    else:
        assert x == y, label


@pytest.fixture
def phase_pair(dev, tmp_path):
    """A controller after the warm-up and iteration 0 (a retrain, whose
    phases and evaluation captured their graphs) and one built with
    ``graphs=False`` loaded with its state."""
    from pdecontrol_tpu_torch.utils import checkpoint as C

    flags = ("--checkpoint_freq", "0", "--total_timesteps", "10")
    graphed = _tiny_controller(tmp_path / "graphed", *flags)
    graphed.learn()
    eager = _tiny_controller(tmp_path / "eager", *flags, graphs=False)
    C.load_controller_state(eager, C.to_host(C.controller_state(graphed)))
    assert eager.graphs is None
    yield graphed, eager
    graphed.logger.finish()
    eager.logger.finish()


PHASES = {
    "collect": (lambda c: c.collect(c.config.rollout_length), ("collect", 1, False)),
    "imagine": (lambda c: c.imagine(2), ("world", 2, 1)),
    "update_policy": (lambda c: c.update_policy(), ("policy", 2)),
    "evaluate_policy": (lambda c: c.evaluate_policy(), ("eval", 8, 2)),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_graphed_phase_equals_the_eager_one(phase_pair, phase):
    """Each retrain phase and the policy evaluation, replayed three times
    from the graph iteration 0 captured: every output and every tensor of
    the controller's state (the generator's too) equal the eager calls'
    bit for bit, and the launch counts advance alike."""
    from pdecontrol_tpu_torch.ops import pallas_ks

    graphed, eager = phase_pair
    call, key = PHASES[phase]
    assert graphed.graphs.get(key) is not None
    for _ in range(3):
        outs = []
        for ctl in (graphed, eager):
            before = pallas_ks.launch_count
            outs.append((call(ctl), pallas_ks.launch_count - before))
        torch.cuda.synchronize()
        _same(outs[0], outs[1], phase)
    _same_state(graphed, eager, phase)


def test_graphed_surrogate_rollout_equals_the_eager_one(phase_pair):
    """``evaluate_surrogate`` (its row and start written into the index
    tensors the graph reads) three times: the first call captures, the
    next two replay; the records and the state equal the eager calls'."""
    graphed, eager = phase_pair
    for ctl in (graphed, eager):
        ctl.collect(8)  # finished episodes to evaluate on
    for i in range(3):
        got = [ctl.evaluate_surrogate(4) for ctl in (graphed, eager)]
        assert got[0] == got[1] and got[0], i
    assert graphed.graphs.get(("sur_eval", 4)) is not None
    _same_state(graphed, eager, "surrogate_rollout")


def test_phase_replay_after_a_rebound_replay_raises(phase_pair):
    """The collect graph writes the replay where it stood at the capture."""
    graphed, _ = phase_pair
    graphed.replay = graphed.replay.__class__(
        **{k: v.clone() for k, v in vars(graphed.replay).items()})
    with pytest.raises(RuntimeError, match=r"replaying the collect phase \('collect'"):
        graphed.collect(1)


def _sac_trainer(tmp_path, graphs):
    import json

    from pdecontrol_tpu_torch.sac import train

    args = train.build_parser().parse_args([
        "--env_config", json.dumps({"n": 32, "cfg_steps": 5, "t_max": 0.04,
                                    "transient_time": 0.5, "solver": "pallas"}),
        "--num_envs", "2", "--learning_starts", "16", "--batch_size", "8",
        "--pool_size", "8", "--num_eval_episodes", "2", "--hidden_size", "32",
        "--run_dir", str(tmp_path)])
    trainer = train.SACTrainer(args, device="cuda", graphs=graphs)
    trainer.run_chunk(8, True, 0)  # the random warmup, eager in both
    return trainer


def _sac_state(trainer):
    from pdecontrol_tpu_torch.utils.graphs import tensors_of

    return tensors_of(trainer.env_state, trainer.tr, trainer.pool, trainer.replay,
                      trainer.sac_state) + [trainer.gen.get_state()]


@pytest.mark.parametrize("route", ["chunk", "evaluate"])
def test_graphed_sac_baseline_equals_the_eager_one(dev, tmp_path, route):
    """Three chunks of 4 env steps with one update each (the first captures,
    the next two replay), or three evaluations, from one state: outputs,
    env state, scaling, replay, networks, Adam state, update counter and
    generator equal the eager trainer's bit for bit."""
    graphed, eager = (_sac_trainer(tmp_path / name, g) for name, g in (("g", True), ("e", False)))
    for a, b in zip(_sac_state(graphed), _sac_state(eager)):
        assert torch.equal(a, b)
    for i in range(3):
        if route == "chunk":
            outs = [t.run_chunk(4, False, 1) for t in (graphed, eager)]
        else:
            outs = [t.evaluate() for t in (graphed, eager)]
        torch.cuda.synchronize()
        _same(outs[0], outs[1], (route, i))
    key = ("chunk", 4, False, 1) if route == "chunk" else ("evaluate", 8)
    assert list(graphed.graphs.graphs) == [key] and eager.graphs is None
    assert graphed.sac_state.updates == eager.sac_state.updates
    for a, b in zip(_sac_state(graphed), _sac_state(eager)):
        assert torch.equal(a, b)


def test_graphed_one_member_fit_equals_the_eager_one(dev):
    """Three epochs of 4, 4 and 3 TBPTT steps (window lengths 5, 6 and 7)
    of a one-member fit, graphed and eager, from one generator state:
    parameters, Adam state, counts, logs and the generator after it equal
    bit for bit."""
    from pdecontrol_tpu_torch.data import replay as R
    from pdecontrol_tpu_torch.envs.transforms import Identity, SampleTransform
    from pdecontrol_tpu_torch.models import factories
    from pdecontrol_tpu_torch.train.losses import make_loss
    from pdecontrol_tpu_torch.train.schedulers import Scheduler
    from pdecontrol_tpu_torch.train.trainer import SurrogateTrainer, TrainConfig
    from pdecontrol_tpu_torch.utils.graphs import GraphCache

    fill = np.array([24] * 6 + [0, 0], np.int32)
    train = torch.as_tensor(np.array([1, 1, 1, 1, 0, 0, 0, 0], bool), device=dev)
    rep = R.create(8, 24, 2, (1, 32), (1, 32), torch.float32, device=dev)
    rng = np.random.default_rng(0)
    rep.obs_seq.copy_(torch.as_tensor(rng.normal(size=tuple(rep.obs_seq.shape))))
    rep.actions.copy_(torch.as_tensor(rng.uniform(-1, 1, tuple(rep.actions.shape))))
    rep.fill.copy_(torch.as_tensor(fill))
    curriculum = Scheduler.factory({"scheduler": "LinearScheduler", "steptype": "epoch",
                                    "start": 0, "stop": 2, "vmin": 3, "vmax": 5})
    out = {}
    for name in ("graphed", "eager"):
        torch.manual_seed(0)
        module = factories.make("KSAutoRegConvolutionalLSTM", delta=0.25, N=32).to(dev)
        tr = SurrogateTrainer(make_loss("MSELoss", {}), TrainConfig(
            tau=2, tbtt=4, lr=2e-3, lr_gamma=0.5, step_size=1, batch_size=4, patience=50,
            max_epochs=3, gradient_clip_val=0.5))
        gen = torch.Generator(device=dev).manual_seed(1)
        if name == "graphed":
            tr.graphs = GraphCache([gen])
        state, vl, logs = tr.fit(tr.init(module), rep, train, ~train & (rep.fill > 0),
                                 Identity(), SampleTransform(), curriculum, 0, gen)
        torch.cuda.synchronize()
        out[name] = ([t.clone() for t in state.tensors()], vl, logs, gen.get_state())
        if name == "graphed":
            assert sorted(k[:2] for k in tr.graphs.graphs) == [
                ("fit_one_step", 5), ("fit_one_step", 6), ("fit_one_step", 7),
                ("fit_one_val", 5), ("fit_one_val", 6), ("fit_one_val", 7)]
    (ga, gvl, glogs, ggen), (ea, evl, elogs, egen) = out["graphed"], out["eager"]
    assert "t_fit_capture" in glogs and "t_fit_capture" not in elogs
    for k in ("train_loss", "val_loss", "val_delta_loss", "epochs", "steps", "lr"):
        assert glogs[k] == elogs[k], k
    assert gvl == evl and glogs["steps"] == 11
    for a, b in zip(ga, ea):
        assert torch.equal(a, b)
    assert torch.equal(ggen, egen)


@pytest.mark.parametrize("solver,precision", [("xla", "highest"), ("pallas_packed", "bf16_3x")])
def test_graphed_gate_rollout_equals_the_eager_one(dev, solver, precision):
    """The gate's rollout of 16 envs x (4 + 6) periods with each period
    replayed from its graph, and eagerly: the statistics are equal bit for
    bit, and K2 launches once per period in both."""
    from pdecontrol_tpu_torch.envs.kuramoto import KuramotoSivashinsky
    from pdecontrol_tpu_torch.evaluation import bf16_gate
    from pdecontrol_tpu_torch.ops import pallas_ks_packed

    env = KuramotoSivashinsky.create(solver=solver, pallas_precision=precision, device=dev)
    u0 = torch.rand((16, env.n), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev) * 2 - 1
    got = {}
    for graphs in (True, False):
        before = pallas_ks_packed.launch_count
        got[graphs] = bf16_gate.rollout_stats_from(env, u0, 4, 6, graphs=graphs)
        got[graphs]["K2"] = pallas_ks_packed.launch_count - before
    assert got[True]["K2"] == got[False]["K2"] == (10 if solver == "pallas_packed" else 0)
    np.testing.assert_array_equal(got[True].pop("spectrum"), got[False].pop("spectrum"))
    assert got[True] == got[False]


# --------------------------------------- the families and Burgers on the card
FACTORIES = ["KSAutoRegConvolutionalLSTM", "KSAutoRegFullyConnectedLSTM",
             "KSLatentConvolutionalLSTM", "KSLatentLSTM", "KSDelayCNNSurrogateFactory"]


@pytest.mark.parametrize("reencode", [None, True], ids=["free_run", "reencode_all"])
@pytest.mark.parametrize("factory", FACTORIES)
def test_family_rollout_on_the_card_matches_the_cpu(dev, factory, reencode):
    """The factory widths (N = 64), a 3-step warmup and 3 more steps, held to
    the CPU's float32 rollout at rtol 3e-5 / atol 3e-6.  Two float32 facts
    of the LATENT families shape the comparison (NVIDIA H100 80GB HBM3):

    * their ``deltas`` are differences of decoded outputs over ``delta``, so
      they carry the outputs' rounding times ``2 / delta``; they are held in
      the outputs' units (times ``delta``);
    * ``KSLatentConvolutionalLSTM`` re-encoding every step sends its output
      through the random weights' decode-encode round trip, which grows a
      last-bit difference from step to step: the CPU's own float32 outputs
      are 1e-6 to 2e-6 off its float64 ones at the first step and over 1e-4
      at the sixth.  That case is held against the CPU's float64 rollout instead,
      step by step: the card may be off it by twice what the CPU's float32
      rollout is at that step (the final hidden state: at the last), on top
      of the plain tolerance (measured: at most 1.92 times).  ``-s`` prints
      both errors by step."""
    from pdecontrol_tpu_torch.models import factories
    from pdecontrol_tpu_torch.models.surrogate import LATENT

    torch.manual_seed(3)
    module = factories.make(factory, delta=0.25, N=64)
    rng = np.random.default_rng(4)
    states = torch.as_tensor(rng.normal(size=(8, 3, 1, 64)), dtype=torch.float32)
    actions = torch.as_tensor(rng.uniform(-1, 1, (8, 6, 1, 64)), dtype=torch.float32)
    amplified = factory == "KSLatentConvolutionalLSTM" and reencode
    with torch.no_grad():
        ref = module.rollout(states, actions, reencode=reencode)
        if amplified:
            ref64 = module.double().rollout(states.double(), actions.double(),
                                            reencode=reencode)
            module.float()
        got = module.to(dev).rollout(states.to(dev), actions.to(dev), reencode=reencode)
    pairs = [(f, getattr(got, f), getattr(ref, f),
              getattr(ref64, f) if amplified else None)
             for f in ("outputs", "deltas", "inlatents", "outlatents")]
    pairs += [(f"hidden[{i}]", g, r, ref64.hidden[i] if amplified else None)
              for i, (g, r) in enumerate(zip(got.hidden, ref.hidden))]
    for name, g, r, r64 in pairs:
        assert g.device.type == "cuda", name
        scale = module.delta if name == "deltas" and module.mode == LATENT else 1.0
        g = g.cpu() * scale
        if not amplified:
            torch.testing.assert_close(g, r * scale, rtol=3e-5, atol=3e-6,
                                       msg=lambda m: f"{name}: {m}")
            continue
        # [B, T, ...] fields by step; the hidden state as one last step.
        steps = (0, 2, 3) if r.ndim == 4 and not name.startswith("hidden") else ()
        cpu_err = ((r - r64).abs() * scale).amax(dim=steps, keepdim=True)
        card_err = (g - r64 * scale).abs().amax(dim=steps, keepdim=True)
        print(f"{name}: max |cpu32 - cpu64| {cpu_err.flatten().tolist()}, "
              f"max |card - cpu64| {card_err.flatten().tolist()}")
        bound = 3e-6 + 3e-5 * (r64 * scale).abs() + 2.0 * cpu_err
        excess = (g - r64 * scale).abs() - bound
        assert float(excess.max()) <= 0, f"{name}: {float(excess.max()):.3e} over the bound"


@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
@pytest.mark.parametrize("batch", [1, 10, 100])
def test_burgers_period_on_the_card_matches_the_cpu(dev, objective, batch):
    """One control period of 250 Heun sub-steps at the env's defaults; no KS
    kernel launches."""
    from pdecontrol_tpu_torch.envs.burgers import Burgers
    from pdecontrol_tpu_torch.envs.kuramoto import EnvState
    from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed

    before = pallas_ks.launch_count, pallas_ks_packed.launch_count
    cpu = Burgers.create(objective=objective, legacy_objective=False)
    gpu = Burgers.create(objective=objective, legacy_objective=False, device=dev)
    u = cpu.sample_ic(torch.Generator().manual_seed(batch), (batch,))
    a = torch.as_tensor(np.random.default_rng(batch).uniform(-1, 1, (batch, 1, 4)),
                        dtype=torch.float32)
    step = torch.zeros((batch,), dtype=torch.int32)
    _, ref = cpu.step(EnvState(u=u, step=step), a)
    _, got = gpu.step(EnvState(u=u.to(dev), step=step.to(dev)), a.to(dev))
    assert got.obs.device.type == "cuda" and got.reward.shape == (batch,)
    torch.testing.assert_close(got.obs.cpu(), ref.obs, rtol=3e-5, atol=3e-6)
    torch.testing.assert_close(got.reward.cpu(), ref.reward, rtol=3e-5, atol=3e-6)
    assert (pallas_ks.launch_count, pallas_ks_packed.launch_count) == before


def test_replay_draw_is_reproducible_on_the_card(dev):
    """The replay's row draw (``data/replay.py::_categorical``) from one
    generator state gives the same rows in every call, over a world replay
    of the 4x1 mesh's size (120,000 rows) filled from 4,000 to 40,000 rows.
    ``torch.multinomial`` on the same weights, and a float ``cumsum`` of
    their probabilities, are printed beside it: the card's scan sums in an
    order that varies from call to call."""
    from pdecontrol_tpu_torch.data import replay as R

    gen = torch.Generator(device=dev)
    for filled in (4000, 8000, 12000, 16000, 20000, 40000):
        w = torch.zeros(120000, device=dev)
        w[:filled] = torch.randint(1, 5, (filled,), device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(1)).float()
        drawn, multinomial, cumsum = set(), set(), set()
        for _ in range(40):
            gen.manual_seed(0)
            drawn.add(R._categorical(w, 1024, gen).cpu().numpy().tobytes())
            gen.manual_seed(0)
            multinomial.add(torch.multinomial(w + 1e-30, 1024, replacement=True,
                                              generator=gen).cpu().numpy().tobytes())
            cumsum.add(torch.cumsum(w / w.sum(), 0).cpu().numpy().tobytes())
        print(f"filled {filled}: distinct over 40 calls: the replay's draw {len(drawn)}, "
              f"torch.multinomial {len(multinomial)}, float cumsum {len(cumsum)}")
        assert len(drawn) == 1


# ------------------------------------------------------------ the mesh
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two rank processes on the one card, through gloo
    (``tests/torch_mesh_ranks.py`` in its ``cuda`` mode), each with a time
    limit; their receipts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json
    import os
    import sys

    from pdecontrol_tpu_torch.parallel.dryrun import free_port, launch

    out = tmp_path_factory.mktemp("ranks")
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_ranks.py")
    address = f"localhost:{free_port()}"
    launch([[sys.executable, script, "cuda", str(i), "2", address, str(out)] for i in range(2)],
           240, str(out))
    return [json.load(open(out / f"cuda{i}.json")) for i in range(2)]


def test_mean_and_gather_replayed_from_a_graph_equal_their_eager_calls(two_ranks):
    """With a card each, the ranks meet through NCCL, whose collectives a
    CUDA graph captures: ``Mesh.mean_`` and ``Mesh.gather`` in one body,
    replayed 3 times on fresh inputs, equal an eager call of the body on
    the same inputs bit for bit on both ranks."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL refuses two ranks on one")
    for r in two_ranks:
        assert r["backend"] == "nccl"
        assert r["graph_collectives"] == [True, True, True]


def test_one_nccl_rank_captures_its_all_reduce(dev):
    """``chip_smoke.py``'s phase 18 (``mesh_smoke.py one``): a process group
    of one NCCL rank, whose ``dist.all_reduce`` a graph captures and
    replays 3 times, each replay equal to the eager body bit for bit."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "pdecontrol_tpu_torch.parallel.mesh_smoke",
                           "one"], cwd=root, capture_output=True, text=True, timeout=180,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (r["backend"], r["world_size"], r["captured"]) == ("nccl", 1, True)
    assert r["equal"] == [True, True, True]


def test_ranks_take_their_device_and_backend_from_the_layout(two_ranks):
    """On one card both ranks share it through gloo; with a card each, NCCL."""
    count = torch.cuda.device_count()
    want = "gloo" if count < 2 else "nccl"
    assert [(r["device"], r["backend"]) for r in two_ranks] == [
        (f"cuda:{i % count}", want) for i in range(2)]


def test_gather_by_all_reduce_equals_concatenation(two_ranks):
    """Float32, int32 and bool rows of two ranks, gathered through a sum of
    zero-filled buffers on the card: bitwise the whole tensors."""
    assert all(r["gather_equal"] for r in two_ranks)


def test_sharded_collect_through_k1_equals_one_rank(two_ranks):
    """Three steps of 10 envs, 5 a rank, through K1 (one warp per row): the
    rewards, the fields and the step counters equal the same steps on one
    rank bitwise; each rank launched K1 3 times on its 5 rows for them."""
    for r in two_ranks:
        assert r["collect_equal"]
        assert r["k1"] == [3, 15]


def test_sac_gradient_all_reduce_keeps_the_networks_on_the_card(two_ranks):
    """One SAC update with the batch over data: the networks and their
    averaged gradients stay on the card, and are equal on both ranks."""
    assert all(r["sac_on_card"] for r in two_ranks)
    assert two_ranks[0]["sac_params"] == two_ranks[1]["sac_params"]
    print("largest gap to the one-rank update:", [r["sac_gap"] for r in two_ranks],
          "qf_loss:", [r["sac_qf_gap"] for r in two_ranks])


def test_sac_on_two_data_ranks_against_one_process_over_200_updates(two_ranks):
    """The same 200 batches of 512 and noises: ``SAC(mesh=)`` on two data
    ranks (each on its half, gradients averaged through gloo) and one
    process on the whole batch, in float32 and float64.  The ranks agree
    exactly; each gap to one process is printed beside the gap one process
    makes by reversing each batch's rows (another summation order alone)."""
    a, b = two_ranks
    assert a["sac_series_last"]["mesh"] == b["sac_series_last"]["mesh"]
    keys = [f"sac_series_{t}{k}_gaps" for t in ("", "float64_") for k in ("mesh", "reorder")]
    for r in two_ranks:
        for k in keys:
            assert all(np.isfinite(v) for v in r[k].values()), k
    print("200 SAC updates, relative gaps of the last losses to one process: "
          + "; ".join(f"{k[len('sac_series_'):-len('_gaps')]} {a[k]}" for k in keys))
