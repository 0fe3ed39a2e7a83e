"""Many-sequence replay: B independent filters, spread over the devices.

Counterpart of ``orcvio_tpu/parallel/replay.py``, the scale-out layer the
reference lacks (its batch evaluation is a serial loop over rosbags,
batch_run_euroc.py:92-100). The batch of sequences is cut into contiguous
chunks, one per device of the mesh; each chunk runs as torch.func.vmap of
the single-stream ``filter_step``, frame after frame, and no device talks
to another inside the loop (the JAX package's shard_map, which inserts no
collectives). The chunks' results are gathered on the mesh's first device
once the loop is done. On one card the mesh has one device and the batch is
one chunk.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from ..config.core import FilterConfig
from ..filter.pipeline import FrameOutput, filter_step
from ..tree import tree_map
from ..utils.profiling import span


def make_mesh(n_devices=None):
    """The first n_devices CUDA devices (default: all of them).

    Raises RuntimeError where there is no card."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device is available")
    n_devices = n if n_devices is None else n_devices
    if not 1 <= n_devices <= n:
        raise ValueError(f"make_mesh: {n_devices} devices asked, {n} present")
    return [torch.device("cuda", i) for i in range(n_devices)]


def batched_step(cfg: FilterConfig):
    """step(states, frames, chi2): filter_step vmapped over a leading batch
    (sequence) axis of states and frames."""

    def step(states, frames, chi2):
        return torch.func.vmap(lambda s, f: filter_step(cfg, s, f, chi2))(
            states, frames)

    return step


def shard_batch(tree, mesh):
    """The batch tree cut on its leading axis into contiguous chunks, as
    even as they come, chunk i on mesh[i]; devices that would get no row
    get no chunk."""
    n = len(mesh)
    B = pytree.tree_leaves(tree)[0].shape[0]
    sizes = [B // n + (i < B % n) for i in range(n)]
    chunks, start = [], 0
    for dev, size in zip(mesh, sizes):
        if size:
            chunks.append(tree_map(
                lambda x, a=start, b=start + size: x[a:b].to(dev), tree))
        start += size
    return chunks


def sharded_replay_fn(cfg: FilterConfig, mesh):
    """fn(states, frames, chi2) -> (states, outputs): B sequences' replays
    of T frames, one sequence per row. states: stacked FilterStates (B,
    ...); frames: FrameInput of (B, T, ...) tensors; chi2: the chi-square
    table. Each device runs its chunk's frames in order through
    ``batched_step``; the devices' launches interleave frame by frame, so
    several cards run at once. Returns the final states (B, ...) and
    FrameOutput of (B, T, ...) tensors on mesh[0]. A call runs in the span
    ``replay.call`` (``utils/profiling.py:span``), which holds
    ``replay.shard``, a ``replay.step`` for each chunk's frame (the
    filter's stage spans inside) and ``replay.gather``; the frames'
    slicing lies in the call's own time."""
    step = batched_step(cfg)

    def replay(states, frames, chi2):
        with span("replay.call"):
            with span("replay.shard"):
                st = shard_batch(states, mesh)
                fr = shard_batch(frames, mesh)
                tables = [chi2.to(chunk.P.device) for chunk in st]
            outs = [[] for _ in st]
            for k in range(frames.t.shape[1]):
                for i, tab in enumerate(tables):
                    frame = tree_map(lambda x: x[:, k], fr[i])
                    with span("replay.step"):
                        st[i], out = step(st[i], frame, tab)
                    outs[i].append(out)
            with span("replay.gather"):
                outs = [FrameOutput(*(torch.stack(x, 1) for x in zip(*o)))
                        for o in outs]

                def gather(*xs):
                    return torch.cat([x.to(mesh[0]) for x in xs])

                return tree_map(gather, *st), tree_map(gather, *outs)

    return replay
