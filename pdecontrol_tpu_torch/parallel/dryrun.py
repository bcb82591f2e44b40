"""Multi-process dry run of the mesh (port of ``pdecontrol_tpu/parallel/dryrun.py``):

    python -m pdecontrol_tpu_torch.parallel.dryrun N [--platform cpu] [--timeout S]

It starts ``N`` rank processes (``parallel/dryrun_mp.py``) on the JAX dry
run's mesh (``data N/2 x model 2`` where ``N`` is even) and one process
without a mesh beside them, and holds their receipts to the JAX dry run's:

  * stages 1-3 (the sharded collect, one ensemble step over ``model``, one
    SAC update over ``data``): the results and the generator's state equal
    bitwise on every rank, and within ``STAGE_TOL`` of the same step
    without the mesh;
  * stages 4-6 of the JAX dry run, one stage here, since every mesh of the
    port is one process per rank: a full ``learn()`` on the mesh with a
    snapshot after every iteration, where every rank's generator passes
    through the same states as the one-process run's, phase by phase, the
    replicated state is equal bitwise on every rank, exactly one rank is
    primary, every other rank's run directory is empty, every rank's
    restore of the primary's last snapshot equals its live state, and the
    primary's metrics equal the one-process run's on every field that does
    not read the clock (``rel_tol`` 1e-4, ``abs_tol`` 1e-6,
    ``pdecontrol_tpu/parallel/dryrun.py:298-341``).

The ranks meet at a free port of this host on the card, and through a
rendezvous file in a temporary directory on the CPU.  On a host with one
card all ranks share it, through gloo.  Every process has a wall-clock
limit; when one fails or runs past it, every process is killed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

# Stages 1-3 against the same step without the mesh.  Stage 1 is float32
# through K1 (one warp per row, so a row does not depend on the batch; on
# the CPU the plain version's product may sum in another order for another
# batch), stages 2 and 3 are float64, where the mean of the ranks' gradients
# rounds otherwise than the gradient of the whole batch.
STAGE_TOL = {"collect": 1e-6, "train": 1e-9, "sac": 1e-9}
# Record fields that read the host's clock or its garbage collector, or the
# CUDA graphs' memory pool (the one-process run on the card captures graphs;
# a mesh runs eagerly).
TIMING = ("start", "time", "_time", "env_steps_per_sec", "gc_max_pause", "n_gc2",
          "graph_pool_mb", "fit_graph_pool_mb")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def rendezvous(tmp: str, platform: Optional[str]) -> str:
    """Where the ranks meet: a rendezvous file on the CPU, a free local port
    on the card."""
    if platform == "cpu":
        return "file://" + os.path.join(tmp, "rendezvous")
    return f"localhost:{free_port()}"


def launch(commands: Sequence[Sequence[str]], timeout: float, logdir: str,
           env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run ``commands`` at once, each writing its output to a file in
    ``logdir``, and return the outputs.  When one exits non-zero, or the
    ``timeout`` seconds are up, every process still running is killed (a
    rank left alone would wait in a collective forever) and this raises."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    logs = [os.path.join(logdir, f"proc{i}.log") for i in range(len(commands))]
    procs = []
    for cmd, log in zip(commands, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(list(cmd), stdout=f, stderr=subprocess.STDOUT,
                                          env=env, cwd=repo_root()))
    deadline = time.monotonic() + timeout
    failed, late = None, False
    try:
        while any(p.poll() is None for p in procs):
            failed = next((i for i, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            late = time.monotonic() > deadline
            if failed is not None or late:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = [open(log).read() for log in logs]
    if failed is None:
        failed = next((i for i, p in enumerate(procs) if p.returncode != 0), None)
    if failed is not None:
        codes = [p.returncode for p in procs]
        what = f"ran past its limit of {timeout:.0f} s" if late else "failed"
        raise RuntimeError(f"process {failed} {what} (exit codes {codes}):\n"
                           + outs[failed][-6000:])
    return outs


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-4, abs_tol=1e-6)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def metrics_lines(run_dir: str) -> List[Dict]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def strip_timing(rec: Dict) -> Dict:
    return {k: v for k, v in rec.items() if not (k.startswith("t_") or k in TIMING)}


def check(recs: List[Dict], single: Dict) -> List[str]:
    """The receipts; returns one line per stage, raises on a failure."""
    lines = []
    for stage, keys in (("collect", ("rewards", "generator")), ("train", ("train_loss", "state")),
                        ("sac", ("qf_loss", "state", "generator"))):
        for k in keys:
            vals = {r[stage][k] for r in recs}
            if len(vals) != 1:
                raise AssertionError(f"stage {stage}: {k} differs across ranks: {vals}")
        gap = max(r[stage]["gap"] for r in recs)
        if not gap <= STAGE_TOL[stage]:
            raise AssertionError(f"stage {stage}: {gap:.3e} from the step without the mesh "
                                 f"(tolerance {STAGE_TOL[stage]})")
        lines.append(f"stage {stage}: equal on all {len(recs)} ranks, {gap:.3e} from the "
                     f"step without the mesh (tolerance {STAGE_TOL[stage]})")
    learns = [r["learn"] for r in recs]
    if [r["primary"] for r in learns].count(True) != 1 or not learns[0]["primary"]:
        raise AssertionError(f"primaries: {[r['primary'] for r in learns]}")
    for name in ("iteration", "trail", "digests"):
        vals = [json.dumps(r[name]) for r in learns]
        if len(set(vals)) != 1:
            raise AssertionError(f"learn(): {name} differs across ranks")
    if learns[0]["trail"] != single["trail"]:
        raise AssertionError("learn(): the generator's states differ from the one-process "
                             f"run's: {learns[0]['trail']} against {single['trail']}")
    primary = learns[0]
    for want in ("metrics.jsonl", "config.json"):
        if want not in primary["files"]:
            raise AssertionError(f"the primary wrote no {want}: {primary['files']}")
    if not any(f.startswith("checkpoints") for f in primary["files"]):
        raise AssertionError(f"the primary wrote no checkpoint: {primary['files']}")
    for r in learns[1:]:
        if r["files"]:
            raise AssertionError(f"a non-primary rank wrote {r['files']} into {r['run_dir']}")
    if not all(r["restore_ok"] for r in learns):
        raise AssertionError(f"restores: {[r['restore_ok'] for r in learns]}")
    mesh_m, single_m = metrics_lines(primary["run_dir"]), metrics_lines(single["run_dir"])
    if len(mesh_m) != len(single_m) or not mesh_m:
        raise AssertionError(f"{len(mesh_m)} records against {len(single_m)}")
    fields = 0
    for a, b in zip(mesh_m, single_m):
        a, b = strip_timing(a), strip_timing(b)
        if a.keys() != b.keys():
            raise AssertionError(f"the fields differ: {sorted(a.keys() ^ b.keys())}")
        bad = [(k, a[k], b[k]) for k in a if not _close(a[k], b[k])]
        if bad:
            raise AssertionError(f"the metrics differ from the one-process run's: {bad}")
        fields += len(a)
    same = sum(1 for k, v in learns[0]["digests"].items() if single["digests"][k] == v)
    lines.append(
        f"learn(): {primary['iteration']} iterations; the generator's {len(primary['trail'])} "
        f"phase states equal on every rank and to the one-process run's; the replicated "
        f"state equal on every rank ({same} of {len(single['digests'])} digests also bitwise "
        f"equal to the one-process run's); one primary, "
        f"{len(primary['files'])} files, none on the other ranks; every restore equal to "
        f"the live state; the primary's {len(mesh_m)} records equal the one-process run's "
        f"in {fields} non-clock fields (rel_tol 1e-4, abs_tol 1e-6)")
    return lines


def run(ranks: int, platform: Optional[str] = None, timeout: float = 600.0) -> List[Dict]:
    """Start the ranks and the one-process run, check their receipts and
    print one line per stage; returns the ranks' receipts."""
    py = [sys.executable, "-m", "pdecontrol_tpu_torch.parallel.dryrun_mp"]
    flags = ["--platform", "cpu"] if platform == "cpu" else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        address = rendezvous(tmp, platform)
        commands = [py + [str(i), str(ranks), address, tmp] + flags for i in range(ranks)]
        commands.append(py + ["single", str(ranks), tmp] + flags)
        launch(commands, timeout, tmp)
        recs = []
        for i in range(ranks):
            with open(os.path.join(tmp, f"rank{i}.json")) as f:
                recs.append(json.load(f))
        with open(os.path.join(tmp, "single.json")) as f:
            single = json.load(f)
        for r in recs:
            c = r["sac"]["critic_allreduce"]
            print(f"[dryrun] rank {r['rank']}: device {r['device']}, backend {r['backend']}; "
                  f"the flagship critic's gradients ({c['bytes']} bytes) averaged over data "
                  f"in {c['ms']:.3f} ms", flush=True)
        for line in check(recs, single):
            print(f"[dryrun] {line}", flush=True)
    print(f"[dryrun] {ranks} ranks: every stage ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ranks", type=int, nargs="?", default=4)
    p.add_argument("--platform", choices=("cpu", "gpu", "cuda"), default=None)
    p.add_argument("--timeout", type=float, default=600.0,
                   help="wall-clock limit of every process, in seconds")
    args = p.parse_args(argv)
    run(args.ranks, "cpu" if args.platform == "cpu" else None, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
