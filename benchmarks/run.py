"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``benchmarks/configs/<name>.json``, the MBPO CLI's arguments) under a
traffic mix (``benchmarks/traffic/<name>.json``, which names its window
driver, ``benchmarks/drivers/<driver>.py``).  The run builds the port's
controller from the seed, sets up and warms every shape the window uses,
measures for ``--seconds``, then checks what the timed path produced
against the plain reference (``benchmarks/reference/``) within the cell's
limits (``benchmarks/limits/<workload>.json``).  With ``--trace 0`` the
result carries the cell's end-to-end metrics; with ``--trace 1`` a span of
the window runs under the profiler and the result carries the cell's
per-layer metrics, each read by ``benchmarks/metrics/<name>.py``.

It needs a CUDA device: without one, or with fewer than the cell asks
for, it exits with 2 and prints no result.  Build and kernel caches stay
in ``build/`` inside the checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "pdecontrol_tpu")


def pin_environment() -> None:
    """Every cache a library of the run may write, at fixed paths inside
    the checkout (the port builds its kernels into ``build/kernels``), and
    one host thread for CPU operators from the process's start: the loop's
    host work is launches and small bookkeeping, and on the card's 8-core
    host idle worker threads left the same retrain ~9% slower in some
    processes for a whole window (two sets of six runs, 5.8% spread; with
    one thread 0.85%).  One thread set only at the end of set-up let
    the slow windows back (the first run of each retrain cell in a call)."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(cell_chips: int):
    import subprocess

    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return {"platform": "gpu", "kind": name, "count": cell_chips, "power_limit": limit}


def main(argv=None) -> int:
    args = parse(argv)
    pin_environment()
    sys.path.insert(0, str(ROOT))
    from benchmarks.harness import report
    from benchmarks.harness.cell import Cell, load_module

    cell = Cell.load(args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    torch.set_num_threads(1)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell.device = torch.device("cuda", 0)
    torch.cuda.set_device(cell.device)
    driver = load_module(ROOT / "benchmarks" / "drivers" / f"{cell.traffic['driver']}.py")
    out = driver.run(cell, T_PROCESS)
    found = loaded_forbidden()
    if found:
        print(f"the run loaded {', '.join(found)}: the port's benchmark may load no JAX "
              f"and not the JAX package", file=sys.stderr)
        return 3
    line = report.result(cell, out, device_info(chips))
    report.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
