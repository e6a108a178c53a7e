"""CUDA graphs of the batch runners: a batch of coarse steps as one program.

The port's counterpart of the JAX runners' `jax.jit` around `lax.scan`
(open_ludwig_tpu/solver_dense.py:660-700, solver.py:102-113): a unit of
work (one coarse step, or a pair of them) whose launches all read fixed
addresses (static state buffers, the step record of `solver.StepRecord`)
is captured once into a `torch.cuda.CUDAGraph` and replayed, so the host
issues one graph launch per unit instead of every kernel and tensor
operation.  `GraphSet.run(key, fn)` is that unit under a key that names
what the capture depends on (the unit's kind and the addresses its inputs
lie at):
  - the key's first use runs `fn` eagerly, so that one-time set-up (the
    kernels' `cudaFuncSetAttribute` and occupancy queries, library loads,
    tables copied to the card on first use, the fixed buffers) happens
    outside any capture;
  - its second use captures `fn` into a graph, under
    `torch.cuda.set_sync_debug_mode("error")` (a host sync on the path
    raises), in a memory pool shared by the set's graphs (the temporaries
    of one unit: ghost planes, edge buffers, halos), and replays it;
  - every later use replays it.
A capture or replay that fails raises: nothing runs eagerly in its place.
On the CPU (no graphs) `fn` runs eagerly every time.  Each unit is one
span (`spans`) named by how it ran: `run.eager`, `run.capture` (the
capture and the replay that follows it) or `run.replay`.  The set counts
its replays (`replays`) and adds each graph's captured kernel launches to
`cuda_step.REPLAYED` and `ghost_planes.REPLAYED` at each replay; `report()`
gives the graphs, their captured `cuda_step` launches and the pool's
bytes.

At capture each graph's device operations are counted from its nodes
(`device_ops`: the kernel, copy and memset nodes of the captured
`cudaGraph_t`, read through libcuda): the port's kernels, the ghost
kernels, and the copies and element-wise operations the schedule issues.
Each replay adds them to the counter `graph.ops` and the unit's coarse
steps to `graph.steps` (`spans.COUNTS`), so `graph.ops / graph.steps` is
the device operations a replayed coarse step runs.  The nodes are read
once, at capture; a replay pays two integer additions.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Dict, Hashable, Iterable, List

import torch

from .ops import cuda_step, ghost_planes
from .spans import COUNTS, span

# CUgraphNodeType (cuda.h) of the nodes that run on the card: a kernel, a
# copy, a memset; the others (empty, event, host, wait) order or signal
DEVICE_NODE_TYPES = (0, 1, 2)


@functools.cache
def _libcuda() -> ctypes.CDLL:
    """libcuda, the process's own (torch has loaded it)."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphNodeGetType.restype = ctypes.c_int
    return lib


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{call} returned CUresult {rc}")


def node_types(raw_graph: int) -> List[int]:
    """The CUgraphNodeType of each node of a captured graph (`raw_graph`,
    `torch.cuda.CUDAGraph.raw_cuda_graph()`, a cudaGraph_t = CUgraph)."""
    lib = _libcuda()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(raw_graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int(0)
    out = []
    for node in nodes[:n.value]:
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        out.append(kind.value)
    return out


def device_ops(types: Iterable[int]) -> int:
    """The nodes among `types` that run on the card (`DEVICE_NODE_TYPES`)."""
    return sum(1 for t in types if t in DEVICE_NODE_TYPES)


@contextlib.contextmanager
def no_host_sync():
    """torch.cuda.set_sync_debug_mode("error") for the block: an operation
    that waits for the card (.item(), a copy to the host, nonzero) raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def pool_reserved(pool, device: torch.device):
    """Bytes the caching allocator holds in the graphs' pool `pool` on
    `device` (its segments in `torch.cuda.memory_snapshot`), or None where
    the snapshot does not name segments' pools."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None or seg.get("device") != index:
            continue
        named = True
        if tuple(pid) == tuple(pool):
            total += int(seg["total_size"])
    return total if named else None


def replayed(g: Dict) -> None:
    """A replay of the captured graph `g`: its device operations and coarse
    steps (`g["counts"]`) added to `spans.COUNTS`."""
    for k, n in g["counts"].items():
        COUNTS[k] = COUNTS.get(k, 0) + n


class GraphSet:
    """The graphs of one runner (module docstring)."""

    def __init__(self, name: str):
        self.name = name
        self.graphs: Dict[Hashable, Dict] = {}
        self.warm = set()
        self.pool = None
        self.pool_bytes = 0  # the allocator's segments in the graphs' pool
        self.replays = 0

    def run(self, key: Hashable, fn: Callable[[], object], device: torch.device,
            steps: int = 1):
        """The unit `fn` under `key` (module docstring); `steps`: the coarse
        steps it runs."""
        if device.type != "cuda":
            with span("run.eager"):
                return fn()
        g = self.graphs.get(key)
        if g is None and key not in self.warm:
            self.warm.add(key)
            with span("run.eager"), torch.cuda.device(device):
                return fn()
        with span("run.replay" if g is not None else "run.capture"):
            if g is None:
                g = self._capture(key, fn, device, steps)
            with torch.cuda.device(device):
                g["graph"].replay()
        self.replays += 1
        for counters, launches in ((cuda_step, g["launches"]),
                                   (ghost_planes, g["ghost_launches"])):
            for k, n in launches.items():
                counters.REPLAYED[k] += n
        replayed(g)
        return g["out"]

    def _capture(self, key: Hashable, fn, device: torch.device, steps: int) -> Dict:
        with torch.cuda.device(device):
            torch.cuda.synchronize(device)
            before = dict(cuda_step.CAPTURED)
            before_ghost = dict(ghost_planes.CAPTURED)
            reserved = torch.cuda.memory_reserved(device)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            # the captured cudaGraph_t is kept for its nodes to be read
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=self.pool), no_host_sync():
                out = fn()
            ops = device_ops(node_types(graph.raw_cuda_graph()))
            graph.instantiate()
            torch.cuda.synchronize(device)
            pool = pool_reserved(self.pool, device)
            self.pool_bytes = (pool if pool is not None else self.pool_bytes
                               + max(torch.cuda.memory_reserved(device) - reserved, 0))
        launches = {k: cuda_step.CAPTURED[k] - before[k] for k in before
                    if cuda_step.CAPTURED[k] != before[k]}
        ghost = {k: ghost_planes.CAPTURED[k] - before_ghost[k] for k in before_ghost
                 if ghost_planes.CAPTURED[k] != before_ghost[k]}
        g = {"graph": graph, "out": out, "launches": launches, "ghost_launches": ghost,
             "counts": {"graph.ops": ops, "graph.steps": steps}}
        self.graphs[key] = g
        return g

    def captured_launches(self) -> int:
        return sum(sum(g["launches"].values()) for g in self.graphs.values())

    def report(self) -> str:
        return (f"[Graph] {self.name}: {len(self.graphs)} graph(s) captured, "
                f"{self.captured_launches()} kernel launches captured in all "
                f"({', '.join(str(sum(g['launches'].values())) for g in self.graphs.values())} "
                f"per graph), pool {self.pool_bytes / 1e6:.1f} MB, "
                f"{self.replays} replays")
