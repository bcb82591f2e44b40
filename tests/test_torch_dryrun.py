"""The port's dry run of the mesh (``python -m pdecontrol_tpu_torch.parallel.dryrun
4 --platform cpu``) passes every stage, and its process launcher kills the
whole group when one process fails or runs past its limit (a rank left
alone would wait in a collective forever)."""

import sys
import time

import pytest
import torch

from pdecontrol_tpu_torch.parallel import dryrun


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dry_run_of_four_ranks_passes_every_stage(capsys):
    recs = dryrun.run(4, platform="cpu", timeout=120)
    out = capsys.readouterr().out
    assert [r["backend"] for r in recs] == ["gloo"] * 4
    for stage in ("collect", "train", "sac", "learn()"):
        assert f"[dryrun] stage {stage}" in out or f"[dryrun] {stage}" in out, stage
    assert "every stage ok" in out


@pytest.mark.parametrize("first, limit, match", [
    ("import sys; sys.exit(3)", 60, "process 0 failed"),
    ("import time; time.sleep(60)", 2, "ran past its limit"),
], ids=["a_process_fails", "past_the_limit"])
def test_launch_kills_the_group(first, limit, match, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        dryrun.launch([[sys.executable, "-c", first],
                       [sys.executable, "-c", "import time; time.sleep(60)"]],
                      limit, str(tmp_path))
    assert time.monotonic() - t0 < 30  # the sleeper did not run its course
