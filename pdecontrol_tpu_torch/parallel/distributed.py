"""The multi-process runtime (port of ``pdecontrol_tpu/parallel/distributed.py``).

The JAX package runs one program over a global device mesh, and processes
are an opt-in layer under it.  PyTorch's idiom is one process per rank:
here a ``data_parallel x model_parallel`` mesh is that many processes,
which meet through ``torch.distributed`` at the address the MBPO CLI's
``--coordinator_address``, ``--num_processes`` and ``--process_id`` give
(``mbrl/script.py``).  Single-process runs never touch this module.

The layout decides the rest, never a failure:

  * rank ``i`` runs on ``cuda:{i % torch.cuda.device_count()}``, or on the
    CPU when the caller asks for it;
  * the backend is NCCL when every rank has a card of its own, and gloo
    when ranks share a card or run on the CPU (NCCL refuses two ranks on
    one card; gloo reduces CUDA tensors through host memory).

Host-boundary rules the port keeps (as the JAX package's):

  * every rank seeds its generator alike and draws every random number at
    its global size, keeping its own rows (``parallel/mesh.py``);
  * whatever a rank pulls to the host for a decision or a record is
    replicated: equal on every rank;
  * file I/O (the metrics stream, ``config.json``, checkpoints, artifacts,
    plots, the profiler trace) happens on the primary rank only
    (``is_primary``); every rank restores the same checkpoint, so ranks on
    other hosts need the run directory on a shared filesystem.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def rank_device(process_id: int, platform: Optional[str] = None) -> torch.device:
    """Rank ``process_id``'s device: the CPU under ``--platform cpu``, else
    the card ``process_id`` modulo the cards present (raises without one)."""
    if platform == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: pass --platform cpu to run the ranks on the CPU")
    return torch.device(f"cuda:{process_id % count}")


def backend_for(num_processes: int, device: torch.device) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if device.type == "cuda" and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               platform: Optional[str] = None) -> torch.device:
    """Join the process group as rank ``process_id`` of ``num_processes`` and
    return this rank's device.  ``coordinator_address`` is ``host:port``
    (rank 0 listens there) or a ``torch.distributed`` init URL such as
    ``file:///path`` (a rendezvous file that none of the ranks has used)."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is not in [0, {num_processes})")
    device = rank_device(process_id, platform)
    backend = backend_for(num_processes, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    print(f"[distributed] rank {process_id} of {num_processes}: backend {backend}, "
          f"device {device}", flush=True)
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_primary() -> bool:
    """True on the rank that owns file I/O.  Single-process runs are always
    primary."""
    return not is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
