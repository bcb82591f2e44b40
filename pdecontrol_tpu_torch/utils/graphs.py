"""CUDA graphs of the port's compiled loops (the port's own; the JAX
package's counterpart is one jitted program per static shape, such as
``_fused_jit`` in ``pdecontrol_tpu/mbrl/controller.py``).

``GraphCache`` captures a function of no arguments once per key and replays
it from then on (``GraphCache.run`` runs the first call of a key eagerly and
captures after it):

  * every graph of a cache allocates from one memory pool: the graphs'
    replays never overlap, and what a body keeps between replays lives in
    tensors allocated outside the pool, so they may share it;
  * the generators a body draws from are registered with each graph.  A
    capture leaves their state where it was; a replay advances it by what
    the captured draws consumed, as an eager run of the body would, so a
    snapshot taken after replays holds the state of the eager run;
  * the kernels' launch and row counts (``ops/pallas_ks.py`` and
    ``ops/pallas_ks_packed.py``) go up by what a capture launched each time
    the graph replays, not when it is captured;
  * the addresses of the tensors the body reads and writes are noted at
    the capture and checked before each replay: a graph reads and writes
    fixed addresses, so state that a caller rebound to a new tensor would
    no longer reach it;
  * a graph's output lies in the shared pool, where another graph's
    replay may write its temporaries, so ``run`` hands back a copy of it.

Inside a capture, ``only_if`` makes the work of a block the body of a
conditional node that each replay runs only where a bool on the card holds
(``csrc/graph_conditional.cu``).  Every graph is uploaded to the card at its
capture: left to its first launches, the upload of a graph with such nodes
left the horizon-7 iteration's first 1–100 replays ~15% slower on an H100.

Nothing falls back to running the body eagerly: a capture or replay that
fails raises, naming its key and, in a process of a mesh, its rank.  Under
NCCL a body may hold the mesh's collectives (``parallel/mesh.py``): every
rank captures the same keys in the same order, and each replay meets the
same replay on the other ranks.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
import weakref
from typing import Callable, Dict, Hashable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pdecontrol_tpu_torch.ops import pallas_ks, pallas_ks_packed

# Modules whose ``launch_count`` and ``rows_launched`` count a hand-written
# kernel's launches and the rows they stepped.
KERNEL_MODULES = (pallas_ks, pallas_ks_packed)


def on_rank() -> str:
    """``" on rank i"`` in a process of a mesh, else ``""``: for messages."""
    return f" on rank {dist.get_rank()}" if dist.is_available() and dist.is_initialized() else ""


def copy_into(dst, src) -> None:
    """Write the tensors of ``src`` into those of ``dst`` where they stand,
    field by field through dataclasses, tuples and lists; other fields must
    be equal.  State that a CUDA graph reads stays at its address."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, (tuple, list)):
        if len(dst) != len(src):
            raise ValueError(f"cannot copy {len(src)} fields into {len(dst)}")
        for a, b in zip(dst, src):
            copy_into(a, b)
    elif dst is not src and dst != src:
        raise ValueError(f"cannot copy {src!r} into {dst!r}")


def tensors_of(*objs) -> List[torch.Tensor]:
    """Every tensor held by ``objs``, in a fixed order: through
    dataclasses, tuples, lists and dicts, a module's parameters and buffers,
    and an optimizer's state."""
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.optim.Optimizer):
            walk(list(x.state.values()))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            walk(list(x.values()))

    walk(objs)
    return out


def _copied(out):
    """``out`` with each of its tensors copied, through dicts, tuples and
    lists."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _copied(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_copied(v) for v in out)
    return out


COND_SOURCE = "graph_conditional.cu"
# The bodies of conditional nodes are captured on a stream of their own and
# allocate from a memory pool of their own, which the process keeps: a
# graph holding a body addresses its temporaries at every replay.  Made at
# the first node.
_BODY: Optional[Tuple[torch.cuda.Stream, Tuple[int, int]]] = None


def _conditional_lib() -> ctypes.CDLL:
    from pdecontrol_tpu_torch.ops import cuda_build

    lib = cuda_build.load(COND_SOURCE)
    if lib.graph_if_begin.argtypes is None:
        lib.graph_if_begin.argtypes = [ctypes.c_void_p] * 3
        lib.graph_if_end.argtypes = [ctypes.c_void_p]
        lib.graph_upload.argtypes = [ctypes.c_void_p] * 2
        for fn in (lib.graph_if_begin, lib.graph_if_end, lib.graph_upload):
            fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def only_if(cond: torch.Tensor) -> Iterator[None]:
    """While the current stream captures a CUDA graph: the work the block
    queues becomes the body of a conditional (IF) node of the graph, which
    a replay runs only where ``cond``, a 0-dim bool tensor on the card,
    holds when the replay reaches the node.  The block's host code runs
    once, at the capture.  What the body computes must go into tensors
    allocated before the block: after a replay that skipped it they hold
    what they held before."""
    global _BODY
    if cond.dtype != torch.bool or cond.numel() != 1 or not cond.is_cuda:
        raise ValueError(f"a conditional node needs a bool scalar on the card, "
                         f"not {cond.dtype} {tuple(cond.shape)} on {cond.device}")
    lib = _conditional_lib()
    if _BODY is None:
        _BODY = (torch.cuda.Stream(cond.device), torch.cuda.graph_pool_handle())
    stream, pool = _BODY
    err = lib.graph_if_begin(cond.data_ptr(), torch.cuda.current_stream(cond.device).cuda_stream,
                             stream.cuda_stream)
    if err:
        raise RuntimeError(f"opening a conditional node failed: CUDA error {err}")
    try:
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(cond.device.index, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(cond.device.index, pool)
    finally:
        err = lib.graph_if_end(stream.cuda_stream)
        if err:
            raise RuntimeError(f"closing a conditional node failed: CUDA error {err}")


@dataclasses.dataclass
class CapturedGraph:
    graph: torch.cuda.CUDAGraph
    output: torch.Tensor  # the body's result, rewritten by every replay
    launches: Dict[object, int]  # kernel module -> launches per replay
    addresses: List[int]  # data_ptr of every tensor of the body's state
    seconds: float  # the capture's wall time
    pool_bytes: int  # what the capture added to the shared pool
    rows: Dict[object, int] = dataclasses.field(default_factory=dict)  # module -> rows per replay
    counters: List[int] = dataclasses.field(default_factory=list)  # host counters per replay
    replays: int = 0  # the replays so far

    def replay(self, state: Sequence[torch.Tensor]) -> torch.Tensor:
        if [t.data_ptr() for t in state] != self.addresses:
            raise RuntimeError("the state of a captured CUDA graph moved since its "
                               "capture: it must be updated in place")
        self.graph.replay()
        self.replays += 1
        for module, n in self.launches.items():
            module.launch_count += n
        for module, n in self.rows.items():
            module.rows_launched += n
        return self.output


# Every live cache, so that ``release_all`` reaches each before the process
# group goes (``parallel/distributed.py::shutdown``).
_CACHES: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()


class GraphCache:
    """Captured graphs by key, sharing one memory pool and drawing from
    ``generators``."""

    def __init__(self, generators: Sequence[torch.Generator]):
        self.generators = list(generators)
        self.graphs: Dict[Hashable, CapturedGraph] = {}
        self._pool = None
        _CACHES.add(self)

    def release(self) -> None:
        """Destroy every graph of the cache; a later call of a key captures
        it anew."""
        self.graphs.clear()
        self._pool = None

    def get(self, key: Hashable):
        return self.graphs.get(key)

    def capture(self, key: Hashable, body: Callable[[], torch.Tensor],
                state: Sequence[torch.Tensor]) -> CapturedGraph:
        """Capture ``body`` under ``key``; ``state`` lists the tensors it
        reads and writes, whose addresses every replay checks."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        counts = {m: (m.launch_count, m.rows_launched) for m in KERNEL_MODULES}
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        try:
            # thread_local: the plot and checkpoint threads never touch the
            # capture stream, and "global" would fail their host calls.
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                output = body()
        finally:
            # A capture launches nothing; its replays do.
            launches = {m: m.launch_count - n for m, (n, _) in counts.items()}
            rows = {m: m.rows_launched - r for m, (_, r) in counts.items()}
            for m, (n, r) in counts.items():
                m.launch_count, m.rows_launched = n, r
        err = _conditional_lib().graph_upload(graph.raw_cuda_graph_exec(),
                                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"uploading the graph {key!r} failed: CUDA error {err}")
        torch.cuda.synchronize()
        captured = CapturedGraph(
            graph=graph, output=output,
            launches={m: n for m, n in launches.items() if n},
            rows={m: n for m, n in rows.items() if n},
            addresses=[t.data_ptr() for t in state],
            seconds=time.perf_counter() - t0,
            pool_bytes=torch.cuda.memory_reserved() - reserved,
        )
        self.graphs[key] = captured
        return captured

    def run(self, key: Hashable, body: Callable[[], object],
            state: Callable[[], Sequence[torch.Tensor]], what: str,
            counters: Sequence[Tuple[object, str]] = (),
            captured: Optional[List[CapturedGraph]] = None):
        """``body`` under ``key``: the first call of a key runs it eagerly,
        as a real step (which loads every kernel and sets up every library
        handle and optimizer state it touches), and captures it after that;
        every later call replays the graph and returns a copy of its
        output.  ``state`` gives the tensors the body reads and writes, read
        after the eager run and before each replay.  ``counters`` names the
        host counters the body advances, as (object, attribute) pairs: the
        capture puts them back, and each replay advances them as the capture
        did.  A new capture is appended to ``captured``.  A failed capture
        or replay raises, naming ``what`` and the key."""
        graph = self.graphs.get(key)
        if graph is None:
            out = body()
            before = [getattr(obj, name) for obj, name in counters]
            try:
                graph = self.capture(key, body, state())
            except Exception as e:
                raise RuntimeError(f"capturing {what} {key} as a CUDA graph "
                                   f"failed{on_rank()}: {e}") from e
            finally:
                after = [getattr(obj, name) for obj, name in counters]
                for (obj, name), value in zip(counters, before):
                    setattr(obj, name, value)
            graph.counters = [b - a for a, b in zip(before, after)]
            if captured is not None:
                captured.append(graph)
            return out
        try:
            out = _copied(graph.replay(state()))
        except Exception as e:
            raise RuntimeError(f"replaying {what} {key} failed{on_rank()}: {e}") from e
        for (obj, name), step in zip(counters, graph.counters):
            setattr(obj, name, getattr(obj, name) + step)
        return out


def release_all() -> None:
    """Destroy the graphs of every live cache once the device has run them.
    NCCL destroys a communicator only after every graph that holds its
    collectives is gone: it waits for them, so a process group of NCCL
    ranks destroyed beside a live graph never returns."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for cache in list(_CACHES):
        cache.release()
