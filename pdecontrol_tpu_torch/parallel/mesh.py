"""The device mesh (port of ``pdecontrol_tpu/parallel/mesh.py``).

``data`` shards environments and training batches (data parallelism) and
``model`` shards the ensemble's members.  The JAX package lays
``n`` devices out as ``reshape(n // model_parallel, model_parallel)``; here
the ``n`` ranks of ``parallel/distributed.py`` are laid out alike: rank
``r`` holds data index ``r // model_parallel`` and model index
``r % model_parallel``.  Each rank joins one process group along each axis:
the ranks of its grid column (same model index) for collectives over
``data``, those of its grid row (same data index) for collectives over
``model``.

Every gather is an ``all_reduce`` (sum) of a zero-filled buffer of the
global size into which each rank wrote its own rows: gloo and NCCL both
reduce CUDA tensors that way, and it is exact, since ``x + 0 == x`` (up to
the sign of a zero).

Under NCCL (a card per rank) a CUDA graph captures these collectives, as it
captures the fused iteration and the phases that call them
(``mbrl/controller.py``).  So each is synchronous (no ``Work`` outlives
it), reads nothing on the host, and writes its results in place or into
tensors of the graph's pool; and ``make_mesh`` runs one collective on each
of the rank's groups, since NCCL makes a group's communicator at its first
collective, which it cannot do inside a capture.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pdecontrol_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def rank_grid(num_ranks: int, model_parallel: int) -> np.ndarray:
    """The ranks as the JAX package's device grid ``[data, model]``."""
    if num_ranks % model_parallel:
        raise ValueError(f"{num_ranks} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return np.arange(num_ranks).reshape(num_ranks // model_parallel, model_parallel)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``data_parallel x model_parallel`` mesh and its
    process group along each axis."""

    data_parallel: int
    model_parallel: int
    rank: int
    groups: Dict[str, object]  # axis -> the process group along it

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    def size(self, axis: str) -> int:
        return self.data_parallel if axis == DATA_AXIS else self.model_parallel

    def index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index

    @property
    def backend(self) -> str:
        """The process group's backend, ``nccl`` or ``gloo``, which decides
        the routes that replay CUDA graphs (``controller.graph_routes``)."""
        return dist.get_backend()

    def _slice(self, n: int, axis: str) -> slice:
        size = self.size(axis)
        if n % size:
            raise ValueError(f"{n} rows do not split over the {axis} axis of size {size}")
        k = n // size
        return slice(self.index(axis) * k, (self.index(axis) + 1) * k)

    def data_slice(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` sharded over ``data``."""
        return self._slice(n, DATA_AXIS)

    def model_slice(self, m: int) -> slice:
        """This rank's members of ``m`` sharded over ``model``."""
        return self._slice(m, MODEL_AXIS)

    # ---------------------------------------------------------- collectives
    def gather(self, tensors: Sequence[torch.Tensor], axis: str = DATA_AXIS
               ) -> List[torch.Tensor]:
        """Each of ``tensors`` holds this rank's rows (leading axis) of a
        batch sharded over ``axis``; returns the whole batches, equal on
        every rank of the axis, in the tensors' dtypes.  One collective for
        all of them: the rows travel as float64, which holds every float32,
        int32 and bool exactly."""
        size, index = self.size(axis), self.index(axis)
        if size == 1:
            return list(tensors)
        rows = tensors[0].shape[0]
        flat = [t.reshape(rows, -1) for t in tensors]
        widths = [f.shape[1] for f in flat]
        buf = torch.zeros((size, rows, sum(widths)), dtype=torch.float64,
                          device=tensors[0].device)
        buf[index] = torch.cat([f.to(torch.float64) for f in flat], dim=1)
        dist.all_reduce(buf, group=self.groups[axis])
        out, offset = [], 0
        for t, w in zip(tensors, widths):
            part = buf[:, :, offset: offset + w].reshape((size * rows,) + tuple(t.shape[1:]))
            out.append(part.to(t.dtype))
            offset += w
        return out

    @torch.no_grad()
    def gather_rows_(self, tensors: Sequence[torch.Tensor], axis: str = MODEL_AXIS) -> None:
        """Each of ``tensors`` is whole, but only this rank's rows of it
        (``model_slice`` / ``data_slice`` of its leading axis) are current:
        write the other ranks' rows into it, in place, so that every view
        of its storage stays valid."""
        if self.size(axis) == 1:
            return
        for t in tensors:
            rows = self._slice(t.shape[0], axis)
            t[: rows.start] = 0
            t[rows.stop:] = 0
            dist.all_reduce(t, group=self.groups[axis])

    @torch.no_grad()
    def mean_(self, tensors: Sequence[torch.Tensor], axis: str = DATA_AXIS) -> None:
        """Replace each of ``tensors`` by its mean over the ranks of
        ``axis``, in place (one collective for all of them)."""
        size = self.size(axis)
        if size == 1:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.groups[axis])
        flat /= size
        offset = 0
        for t in tensors:
            t.copy_(flat[offset: offset + t.numel()].view(t.shape))
            offset += t.numel()

    def all(self, flags: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """Whether ``flags`` holds on every row of every rank of ``axis``: a
        0-dim bool tensor on the flags' device, equal on those ranks."""
        unset = torch.sum(~flags, dtype=torch.int64).reshape(1)
        if self.size(axis) > 1:
            dist.all_reduce(unset, group=self.groups[axis])
        return unset[0] == 0

    def barrier(self) -> None:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def make_mesh(data_parallel: int, model_parallel: int = 1) -> Mesh:
    """This rank's mesh over the process group that
    ``distributed.initialize`` joined; its size must be the mesh's."""
    n = data_parallel * model_parallel
    if not distributed.is_initialized():
        raise ValueError(
            f"a {data_parallel}x{model_parallel} device mesh runs one process per "
            f"device: start {n} processes with --coordinator_address, "
            f"--num_processes {n} and --process_id 0..{n - 1}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} needs {n} devices, "
                         f"found {world}")
    grid = rank_grid(n, model_parallel)
    rank = dist.get_rank()
    groups = {}
    # Every rank creates every group, in the same order.
    for axis, lines in ((MODEL_AXIS, grid), (DATA_AXIS, grid.T)):
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    # One collective on each of this rank's groups, eagerly, in the same
    # order on every rank: NCCL makes a group's communicator there, and a
    # CUDA graph cannot capture that.
    mesh = Mesh(data_parallel, model_parallel, rank, groups)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    for axis in (MODEL_AXIS, DATA_AXIS):
        if mesh.size(axis) > 1:
            dist.all_reduce(torch.zeros((1,), device=device), group=groups[axis])
    return mesh
