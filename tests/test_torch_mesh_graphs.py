"""The mesh's graph routes on the CPU: four rank processes of a 2x2 mesh
through gloo (``tests/torch_mesh_ranks.py`` in its ``graphs`` mode, a time
limit each) run the test's tiny ``learn()`` once on the routes of their
backend and once with the backend reported as NCCL, where a recording
stand-in for ``utils.graphs.GraphCache`` runs every graph's body eagerly:

  * every rank asks for the same graph keys, in the same order, as the
    one-process run of the same config;
  * inside each body every rank issues the same mesh collectives (op, axis,
    shape, dtype) in the same order, and the fits' bodies issue none;
  * the fused body and each phase body read no tensor's value on the host
    (a dispatch mode raises on ``aten::_local_scalar_dense``);
  * ``graph_routes`` selects each route as the backend and ``--debug_nans``
    say, and the ranks read the backend from their process group;
  * the NCCL routes' stream equals the gloo routes' bit for bit in every
    field that does not read the clock, and the one-process run's on
    ``tests/test_parallel.py``'s keys at its tolerance.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController, graph_routes
from pdecontrol_tpu_torch.parallel.dryrun import strip_timing
from tests.test_torch_parallel import run_ranks
from tests.test_torch_parallel_learn import KEYS
from tests.torch_mesh_ranks import GRAPHS_CONFIG, controller_config, record_graphs

# The kinds of graph a learn() of the tiny config asks for.
PHASES = {"collect", "world", "policy", "eval"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' receipts, and the keys and bodies of the same
    ``learn()`` at 1x1 here."""
    out = tmp_path_factory.mktemp("graphs")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_ranks("graphs", out)
        ctl = PDEModelBasedController(controller_config(str(out / "single"), **GRAPHS_CONFIG),
                                      device="cpu")
        phases, fit = record_graphs(ctl)
        ctl.learn()
        ctl.logger.finish()
    finally:
        torch.set_num_threads(n)
    ranks = [json.load(open(out / f"graphs{i}.json")) for i in range(4)]
    single = {"keys": [list(k) for k in phases.keys + fit.keys],
              "bodies": [k for k, _ in phases.bodies]}
    return out, ranks, single


def test_every_rank_asks_for_the_one_process_keys_in_order(runs):
    _, ranks, single = runs
    kinds = {k[0] for k in single["keys"]}
    assert PHASES | {"fit_step", "fit_val"} <= kinds
    assert any(isinstance(k[0], int) for k in single["keys"])  # the fused iteration
    for r in ranks:
        assert r["keys"] == single["keys"]


def test_every_rank_issues_the_same_collectives_in_each_body(runs):
    _, ranks, single = runs
    bodies = ranks[0]["bodies"]
    assert [k for k, _ in bodies] == single["bodies"]
    for r in ranks[1:]:
        assert r["bodies"] == bodies
    for key, calls in bodies:
        # Every rank evaluates the whole batch alike, with no collective.
        if key[0] in ("eval", "sur_eval"):
            assert calls == [], key
            continue
        assert calls, f"the body of {key} issued no collective"
        assert {op for op, *_ in calls} <= {"gather", "mean_", "all"}
        assert {axis for _, axis, *_ in calls} == {"data"}
    for r in ranks:
        assert r["fit_bodies"] and all(calls == [] for _, calls in r["fit_bodies"])


def test_the_fused_and_phase_bodies_read_nothing_on_the_host(runs):
    """Each body ran under the dispatch mode that raises on a host read (a
    rank that raised would have failed the fixture)."""
    _, ranks, _ = runs
    for r in ranks:
        kinds = [k[0] for k, _ in r["bodies"]]
        assert PHASES | {"fused"} <= set(kinds)


def test_the_backend_selects_the_routes():
    """Tentpole table: under NCCL every route may replay graphs; under gloo
    the fits only; ``--debug_nans`` none, with or without a mesh."""
    nccl, gloo = (types.SimpleNamespace(backend=b) for b in ("nccl", "gloo"))
    every = {"fused": True, "phases": True, "fit": True}
    none = dict.fromkeys(every, False)
    assert graph_routes(None, False) == every
    assert graph_routes(nccl, False) == every
    assert graph_routes(gloo, False) == {"fused": False, "phases": False, "fit": True}
    for mesh in (None, nccl, gloo):
        assert graph_routes(mesh, True) == none


def test_the_ranks_read_their_routes_from_the_process_group(runs):
    _, ranks, _ = runs
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["routes"] == {
            "gloo": {"fused": False, "phases": False, "fit": True},
            "debug_nans": {"fused": False, "phases": False, "fit": False},
            "nccl": {"fused": True, "phases": True, "fit": True}}


def test_the_nccl_routes_stream_equals_the_gloo_routes_and_one_process(runs):
    out, _, _ = runs
    nccl, gloo, single = (_stream(out / d) for d in ("nccl_p0", "gloo_p0", "single"))
    assert len(nccl) == len(gloo) == len(single) == 4
    assert "t_fused" in nccl[3] and "t_ready" in nccl[1]
    assert [strip_timing(r) for r in nccl] == [strip_timing(r) for r in gloo]
    for a, b in zip(nccl, single):
        for k in KEYS:
            assert (k in a) == (k in b), k
            if k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-7, err_msg=k)


def test_shutdown_destroys_every_graph_before_the_process_group(monkeypatch):
    """NCCL destroys a communicator only after every graph that holds its
    collectives is gone, and waits for them: ``distributed.shutdown``
    empties every live ``GraphCache`` before it leaves the process group."""
    from pdecontrol_tpu_torch.parallel import distributed
    from pdecontrol_tpu_torch.utils.graphs import GraphCache

    caches = [GraphCache([]) for _ in range(2)]
    for i, cache in enumerate(caches):
        cache.graphs[("key", i)] = object()
    seen = []
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed.dist, "destroy_process_group",
                        lambda: seen.append([dict(c.graphs) for c in caches]))
    distributed.shutdown()
    assert seen == [[{}, {}]]
