"""Multi-process scale-out: one process per host (or per card), joined by
torch.distributed.

Counterpart of ``orcvio_tpu/parallel/multihost.py``. The reference's only
distributed plane is ROS topics on one machine. The JAX package joins
every process's devices into one global mesh and builds global arrays
from each process's rows (``jax.make_array_from_process_local_data``), so
its jitted replay spans the cluster. torch has no global array; the port
keeps the meaning instead (ROADMAP section 3 item 27):

* ``global_mesh()``: this process's devices, its rank and the world size;
* ``local_batch_to_global``: each process keeps its own rows, on its own
  devices; outputs and metrics meet through ``all_reduce_sum`` and
  ``all_gather_rows``;
* ``replicate_to_global``: rank 0's values broadcast to every process.

Single-process use needs nothing: ``maybe_initialize()`` does nothing
unless ORCVIO_COORDINATOR, ORCVIO_NUM_PROCESSES and ORCVIO_PROCESS_ID are
set, and every helper here is the identity in one process.
"""
from __future__ import annotations

import logging
import os
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..tree import tree_map

_ENV_COORD = "ORCVIO_COORDINATOR"  # host:port of process 0
_ENV_NPROC = "ORCVIO_NUM_PROCESSES"
_ENV_PID = "ORCVIO_PROCESS_ID"

log = logging.getLogger(__name__)


def maybe_initialize():
    """Join the process group the environment asks for.

    Returns False (and does nothing) without ORCVIO_COORDINATOR; else the
    backend it joined with: "nccl" where every process can have a card of
    its own (this process takes card ORCVIO_PROCESS_ID modulo the count),
    "gloo" otherwise. The rendezvous is tcp://ORCVIO_COORDINATOR."""
    coord = os.environ.get(_ENV_COORD)
    if not coord:
        return False
    if dist.is_initialized():
        return dist.get_backend()
    n = int(os.environ[_ENV_NPROC])
    pid = int(os.environ[_ENV_PID])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= n else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(pid % cards)
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=n, rank=pid)
    log.info("process %d of %d joined %s over %s", pid, n, backend, coord)
    return backend


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _joined() else 1


def process_rank() -> int:
    return dist.get_rank() if _joined() else 0


class ProcessMesh(NamedTuple):
    devices: list  # this process's devices
    rank: int
    world_size: int


def global_mesh(devices=None) -> ProcessMesh:
    """This process's devices (default: its card under nccl, every card
    otherwise, else the CPU), its rank and the world size."""
    if devices is None:
        if _joined() and dist.get_backend() == "nccl":
            devices = [torch.device("cuda", torch.cuda.current_device())]
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")]
    return ProcessMesh(list(devices), process_rank(), world_size())


def process_chunk(tree):
    """This process's contiguous chunk of the tree's leading axis, cut as
    ``parallel/replay.py:shard_batch`` cuts a batch over devices."""
    n, r = world_size(), process_rank()
    B = pytree.tree_leaves(tree)[0].shape[0]
    sizes = [B // n + (i < B % n) for i in range(n)]
    start = sum(sizes[:r])
    return tree_map(lambda x: x[start:start + sizes[r]], tree)


def local_batch_to_global(tree, mesh: ProcessMesh):
    """Each process keeps its own rows: the tree on the mesh's first
    device. (The JAX package's global array has no torch counterpart.)"""
    return tree_map(lambda x: torch.as_tensor(x).to(mesh.devices[0]), tree)


def _via_backend(x, op):
    """op(y) on a copy of x the backend can take (gloo takes CPU tensors,
    nccl CUDA ones); the result back on x's device."""
    if dist.get_backend() == "gloo" and x.is_cuda:
        y = x.cpu()
        op(y)
        return y.to(x.device)
    y = x.clone()
    op(y)
    return y


def all_reduce_sum(x):
    """x summed over the processes (x itself in one process)."""
    if not _joined():
        return x
    return _via_backend(x, lambda y: dist.all_reduce(y, dist.ReduceOp.SUM))


def all_reduce_max(x):
    """x's elementwise maximum over the processes."""
    if not _joined():
        return x
    return _via_backend(x, lambda y: dist.all_reduce(y, dist.ReduceOp.MAX))


def all_gather_rows(x):
    """Every process's rows of x (equal shapes), concatenated in rank
    order on the leading axis."""
    if not _joined():
        return x
    cpu = dist.get_backend() == "gloo"
    src = x.cpu() if cpu else x
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src.contiguous())
    return torch.cat(parts).to(x.device)


def replicate_to_global(tree, mesh: ProcessMesh):
    """Rank 0's values of the tree's tensors on every process, on the
    mesh's first device."""
    def one(x):
        x = torch.as_tensor(x).to(mesh.devices[0])
        if not _joined():
            return x
        return _via_backend(x, lambda y: dist.broadcast(y, src=0))

    return tree_map(one, tree)
