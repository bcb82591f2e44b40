"""Attractor-statistics fidelity gate for the bf16-limb solver modes (port of
``pdecontrol_tpu/evaluation/bf16_gate.py``).

The ``pallas_packed`` solver's limb precisions (``bf16`` 1 pass,
``bf16_3x`` 3, ``bf16_4x`` 4) carry per-period error.  Trajectories of a
chaotic attractor decorrelate at any precision, so fidelity is a statement
about statistics: the long-run attractor statistics of the fast mode must
match those of the float32 plain solver.  The gate runs both through
``KuramotoSivashinsky.step`` for ``--periods`` control periods after a
discarded transient, on a ``--batch``-wide ensemble from one initial field,
and compares

- the mean energy ``<u^2>``,
- the mean dissipation terms ``<u_x^2>`` and ``<u_xx^2>``,
- the energy spectrum ``<|rfft(u)|^2>`` on the wavenumbers carrying at least
  1e-4 of the peak power.

Each period's statistics are written into buffers of ``--periods`` rows at
an index kept on the device, and reduced once at the end, as the JAX gate
reduces its scan's outputs.  On the card one period is a CUDA graph
(``utils/graphs.py``), captured after the first period, which runs
eagerly, and replayed for every later one; the transient's periods are a
graph of their own.  The float32 side keeps the plain solver's operations,
about 13,000 small launches a period, which the graph replays as one.

Exit status 0 means within tolerance; the verdict JSON goes to stdout and,
with ``--output``, to a file.  It runs on the GPU, and stops if there is
none, unless ``--platform cpu`` asks for the CPU (the defaults are the JAX
gate's):

    python -m pdecontrol_tpu_torch.evaluation.bf16_gate --precision bf16_3x
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Union

import numpy as np
import torch

from pdecontrol_tpu_torch.envs.kuramoto import EnvState, KuramotoSivashinsky
from pdecontrol_tpu_torch.ops.kuramoto import ks_derivatives
from pdecontrol_tpu_torch.utils.device import (
    add_platform_argument, entry_device, platform_device)
from pdecontrol_tpu_torch.utils.graphs import GraphCache, copy_into


@torch.no_grad()
def rollout_stats_from(env: KuramotoSivashinsky, u0: torch.Tensor, transient: int,
                       periods: int, graphs: bool = True) -> Dict:
    """Free-attractor rollout of the batch ``u0`` [B, N] through
    ``env.step`` (zero action); attractor statistics over ``periods``
    post-transient control periods.  On the card each period replays a CUDA
    graph unless ``graphs`` is false; the statistics are the same."""
    batch = u0.shape[0]
    dev = u0.device
    state = EnvState(u=u0.to(torch.float32).clone(),
                     step=torch.zeros((batch,), dtype=torch.int32, device=dev))
    actions = torch.zeros((batch, 1, env.num_jets), dtype=torch.float32, device=dev)
    # Per period: <u^2>, <u_x^2>, <u_xx^2> and the spectrum, at row ``index``.
    means = torch.zeros((3, periods), dtype=torch.float32, device=dev)
    spec = torch.zeros((periods, env.n // 2 + 1), dtype=torch.float32, device=dev)
    index = torch.zeros((1,), dtype=torch.int64, device=dev)

    def period():
        stepped, _ = env.step(state, actions)
        copy_into(state, stepped)

    def recorded():
        period()
        u = state.u
        u_x, u_xx, _ = ks_derivatives(env.ops, u)
        row = torch.stack([torch.mean(u * u), torch.mean(u_x * u_x), torch.mean(u_xx * u_xx)])
        means.index_copy_(1, index, row[:, None])
        spec.index_copy_(0, index, torch.mean(torch.abs(torch.fft.rfft(u, dim=-1)) ** 2,
                                              dim=0)[None])
        index.add_(1)

    cache = GraphCache([]) if graphs and dev.type == "cuda" else None
    for key, body, count in (("transient", period, transient), ("period", recorded, periods)):
        for _ in range(count):
            if cache is None:
                body()
            else:
                cache.run(key, body, lambda: [state.u, state.step, means, spec, index],
                          f"the gate's {env.solver}/{env.pallas_precision} {key}")
    return {
        **dict(zip(("mean_energy", "mean_ux2", "mean_uxx2"),
                   torch.stack([m.mean() for m in means]).tolist())),
        "spectrum": spec.mean(0).cpu().numpy(),
    }


def rollout_stats(env: KuramotoSivashinsky, generator: torch.Generator, batch: int,
                  transient: int, periods: int) -> Dict:
    """``rollout_stats_from`` on a batch drawn ``U(-1, 1)`` from ``generator``
    (on the env's device)."""
    u0 = torch.rand((batch, env.n), generator=generator, dtype=torch.float32,
                    device=env.device) * 2.0 - 1.0
    return rollout_stats_from(env, u0, transient, periods)


def compare(fp32: Dict, bf16: Dict, rtol_means: float, rtol_spec: float) -> Dict:
    """Relative-error comparison; the spectrum is compared bin-wise on
    wavenumbers carrying at least 1e-4 of the peak power (the tail bins hold
    no energy, only noise)."""
    checks = {}
    for k in ("mean_energy", "mean_ux2", "mean_uxx2"):
        rel = abs(bf16[k] - fp32[k]) / abs(fp32[k])
        checks[k] = {"fp32": fp32[k], "fast": bf16[k],
                     "rel_err": rel, "tol": rtol_means,
                     "ok": bool(rel <= rtol_means)}
    s32, s16 = fp32["spectrum"], bf16["spectrum"]
    band = s32 >= 1e-4 * s32.max()
    rel = np.abs(s16[band] - s32[band]) / s32[band]
    checks["spectrum"] = {
        "bins_compared": int(band.sum()),
        "max_rel_err": float(rel.max()),
        "mean_rel_err": float(rel.mean()),
        "tol": rtol_spec,
        "ok": bool(rel.max() <= rtol_spec),
    }
    checks["ok"] = all(v["ok"] for v in checks.values())
    return checks


def run_gate(batch: int = 512, transient: int = 100, periods: int = 400,
             rtol_means: float = 0.02, rtol_spec: float = 0.10,
             seed: int = 0, precision: str = "bf16_4x",
             device: Union[None, str, torch.device] = None) -> Dict:
    """The gate: the float32 plain solver against ``pallas_packed`` at
    ``precision``, both from the same initial batch, on ``device`` (``None``:
    the GPU, which must exist)."""
    device = entry_device(device)
    envs = {
        "fp32": KuramotoSivashinsky.create(solver="xla", device=device),
        "fast": KuramotoSivashinsky.create(solver="pallas_packed",
                                           pallas_precision=precision, device=device),
    }
    stats = {
        name: rollout_stats(env, torch.Generator(device=device).manual_seed(seed),
                            batch, transient, periods)
        for name, env in envs.items()
    }
    verdict = compare(stats["fp32"], stats["fast"], rtol_means, rtol_spec)
    verdict["config"] = {
        "batch": batch, "transient_periods": transient, "periods": periods,
        "total_agent_steps": batch * periods, "precision": precision,
        "device": str(device),
    }
    return verdict


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--transient", type=int, default=100)
    p.add_argument("--periods", type=int, default=400)
    p.add_argument("--rtol_means", type=float, default=0.02)
    p.add_argument("--rtol_spec", type=float, default=0.10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", type=str, default="bf16_4x",
                   choices=("bf16", "bf16_3x", "bf16_4x"))
    p.add_argument("--output", type=str, default=None)
    add_platform_argument(p)
    args = p.parse_args(argv)

    verdict = run_gate(args.batch, args.transient, args.periods,
                       args.rtol_means, args.rtol_spec, args.seed,
                       args.precision, platform_device(args.platform))
    blob = json.dumps(verdict, indent=2)
    print(blob)
    if args.output:
        with open(args.output, "w") as f:
            f.write(blob + "\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
