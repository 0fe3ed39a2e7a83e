"""Scaling harness: weak scaling of the many-sequence replay.

Counterpart of ``orcvio_tpu/eval/scaling.py``. BASELINE.md asks for at
least 80 % scaling efficiency from one card to many. Per-device work is
held constant (``seqs_per_device`` filters replaying a T-frame synthetic
sequence through ``parallel/replay.py:sharded_replay_fn``) while the
device count grows, so

    efficiency(N) = fps(N) / (N fps(1)).

One process drives the devices of its mesh (the cards, or CPU "devices"
that share the host's cores); several processes, each started with
ORCVIO_COORDINATOR, ORCVIO_NUM_PROCESSES and ORCVIO_PROCESS_ID
(``parallel/multihost.py``), replay their own rows and meet only after
the timed loop: frames summed, the slowest process's time. The JAX
package counts the collectives in its compiled program; the port counts
the ``torch.distributed`` collectives issued inside the timed loop
(``hot_loop_collectives``, which must be 0: the filters never talk).

Usage: ``python -m orcvio_tpu_torch.eval.scaling [--devices 1,2]
[--frames N] [--device cpu] [--size tiny]`` (the card unless --device
says otherwise). Prints one JSON line (rank 0).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

# the filter and world of the harness (the JAX package's _build), and the
# tiny ones of its multi-device dry run (__graft_entry__.py:133-139)
SIZES = {
    "default": (dict(sw_size=10, max_features=60, max_track_len=6,
                     imu_slab=12, observation_noise=0.004,
                     tri_translation_threshold=-1.0),
                dict(n_landmarks=200, max_obs=30, imu_slab=12, seed=0)),
    "tiny": (dict(sw_size=4, max_features=24, max_track_len=3, imu_slab=4,
                  observation_noise=0.004, tri_translation_threshold=-1.0),
             dict(n_landmarks=60, max_obs=12, imu_slab=4, seed=0)),
}
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
               "all_to_all_single", "broadcast", "reduce", "gather",
               "scatter", "barrier", "send", "recv", "isend", "irecv")


def _build(n_frames: int, dtype, device, size: str = "default"):
    """(cfg, state, frames, chi2) of the harness's synthetic run."""
    from ..config.core import FilterConfig
    from ..dataio.synthetic import SimConfig, initialized_run

    cfg_kw, sim_kw = SIZES[size]
    cfg = FilterConfig(**cfg_kw)
    st, frames, chi2 = initialized_run(
        cfg, SimConfig(n_frames=n_frames, **sim_kw), dtype, device)
    return cfg, st, frames, chi2


@contextlib.contextmanager
def count_collectives():
    """{"n": calls} of torch.distributed's collectives made inside."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    box = {"n": 0}
    saved = []
    for mod in (dist, c10d):
        for name in COLLECTIVES:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def counted(*a, _fn=fn, **kw):
                box["n"] += 1
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield box
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(device_counts, seqs_per_device: int = 2, n_frames: int = 100,
            reps: int = 3, dtype: str = "float32", device=None,
            size: str = "default"):
    """Weak scaling over device counts: one result a count, each with the
    replay's frames/s and the collectives issued in its timed loop.

    device: the devices' type (the card unless given); on the CPU a
    "mesh" of N repeats the CPU, so its efficiency shows the cores'
    contention, not the program's. Under several processes the count is
    the whole cluster's and fps the cluster's."""
    from .. import no_tf32, resolve_device
    from ..parallel import multihost
    from ..parallel.replay import sharded_replay_fn
    from ..tree import tree_map

    dev = resolve_device(device)
    no_tf32()
    backend = multihost.maybe_initialize()
    world = multihost.world_size()
    tdtype = torch.float32 if dtype == "float32" else torch.float64
    cfg, st, frames, chi2 = _build(n_frames, tdtype, dev, size)
    # the cards this process drives; on the CPU a "mesh" repeats the CPU
    gm = multihost.global_mesh(None if dev.type == "cuda" else [dev])
    n_avail = len(gm.devices) * world if dev.type == "cuda" else None
    if backend:
        # every process runs its own devices' rows: the whole cluster
        device_counts = [len(gm.devices) * world]
        chi2 = multihost.replicate_to_global(chi2, gm)

    results = []
    for n_dev in device_counts:
        local_n = n_dev // world
        mesh = (gm.devices[:local_n] if dev.type == "cuda"
                else gm.devices * local_n)
        B_local = local_n * seqs_per_device
        states, seqs = multihost.local_batch_to_global(tree_map(
            lambda x: x.expand(B_local, *x.shape).clone(), (st, frames)), gm)
        fn = sharded_replay_fn(cfg, mesh)
        out_states, _ = fn(states, seqs, chi2)  # warm
        _sync(mesh[0])
        if backend:
            torch.distributed.barrier()
        with count_collectives() as calls:
            t0 = time.perf_counter()
            for _ in range(reps):
                out_states, outs = fn(states, seqs, chi2)
            for d in set(mesh):
                _sync(d)
            seconds = time.perf_counter() - t0
        finite = bool(torch.isfinite(outs.p).all())
        # the processes meet here, after the timed loop
        tot = multihost.all_reduce_sum(torch.tensor(
            [B_local * n_frames * reps, float(finite)], dtype=torch.float64))
        slowest = multihost.all_reduce_max(torch.tensor([seconds],
                                                        dtype=torch.float64))
        results.append({"devices": n_dev, "processes": world,
                        "batch": B_local * world,
                        "fps": float(tot[0] / slowest[0]),
                        "seconds": float(slowest[0]),
                        "finite": bool(tot[1] == world),
                        "hot_loop_collectives": calls["n"]})

    base = results[0]
    for r in results:
        r["efficiency"] = r["fps"] / (r["devices"] / base["devices"]
                                      * base["fps"])
    return {"weak_scaling": results,
            "scaling_efficiency": results[-1]["efficiency"],
            "multihost": backend, "n_devices_available": n_avail,
            "device": dev.type,
            "cards": torch.cuda.device_count() if dev.type == "cuda" else 0,
            "size": size, "dtype": dtype,
            "frames": n_frames, "reps": reps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="1",
                    help="device counts, comma-separated")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seqs-per-device", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--size", default="default", choices=sorted(SIZES))
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    out = measure([int(x) for x in args.devices.split(",")],
                  seqs_per_device=args.seqs_per_device, n_frames=args.frames,
                  reps=args.reps, dtype=args.dtype, device=args.device,
                  size=args.size)
    from ..parallel import multihost

    if multihost.process_rank() == 0:
        print(json.dumps(out), flush=True)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
