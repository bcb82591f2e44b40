"""The control and the planted faults fail the comparison at each cell's own
size, on the card: the plain reference put in the program's place in a
lower precision (TF32 on, where the configuration states float32 with TF32
off), with half of each batch left out, or with an answer altered where it
is produced.  Run on the card with

    python -m pytest -m cuda benchmarks/tests/test_bench_control.py
"""

import pytest
import torch

from bench_readings import readings
from benchmarks.harness.cell import Cell

SEEDS = (2147483659, 3000000019, 4000000007)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ks_autoreg-h7", "ks_autoreg-retrain",
                                      "ks_latent_r4-retrain"])
def test_control_and_faults_fail(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size")
    for seed in SEEDS:
        cell = Cell.load(workload, seed, 2.0, False)
        cell.device = torch.device("cuda", 0)
        line = readings(cell)
        assert line["correct"], line
        for name, r in line["stand_ins"].items():
            assert not r["correct"], (seed, name, r)
