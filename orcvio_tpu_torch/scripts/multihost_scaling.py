"""Multi-process weak scaling of the many-sequence replay on one machine.

Counterpart of the JAX repository's ``scripts/multihost_scaling.py``.
Launches N worker processes of ``python -m orcvio_tpu_torch.eval.scaling``,
each pinned to its own cores (``taskset``, where present) and joined into
one torch.distributed group over localhost (``parallel/multihost.py``):
the small-scale model of "one card per host". First one worker alone (the
baseline), then N; every worker gets the same number of cores, so the
efficiency compares equal compute.

Workers on the CPU use gloo. On a machine with fewer cards than workers
the workers would share a card: that measures contention, not scaling,
and the output says so ("shared_card"). Several cards' numbers need a
machine with several cards.

Usage: ``python orcvio_tpu_torch/scripts/multihost_scaling.py [--procs 2]
[--frames 60] [--size tiny] [--device cpu]`` (the card unless --device
says otherwise). Prints one JSON line: the baseline's frames/s, the
cluster's, the efficiency and the collectives in the timed loop.
"""
import argparse
import json
import os
import shutil
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(n_procs: int, args, cores, timeout: float = 600.0):
    """n_procs workers, each on len(cores) // n_procs of `cores`; returns
    worker 0's JSON."""
    port = free_port()
    per = max(1, len(cores) // n_procs)
    taskset = shutil.which("taskset")
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ, ORCVIO_COORDINATOR=f"127.0.0.1:{port}",
                   ORCVIO_NUM_PROCESSES=str(n_procs),
                   ORCVIO_PROCESS_ID=str(pid), OMP_NUM_THREADS=str(per))
        cmd = [sys.executable, "-m", "orcvio_tpu_torch.eval.scaling",
               "--frames", str(args.frames), "--size", args.size,
               "--reps", str(args.reps),
               "--seqs-per-device", str(args.seqs_per_device)]
        if args.device:
            cmd += ["--device", args.device]
        mine = cores[pid * per:(pid + 1) * per] or cores[:1]
        if taskset:
            cmd = [taskset, "-c", ",".join(map(str, mine))] + cmd
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
            stderr=subprocess.PIPE))
    try:
        out, err0 = procs[0].communicate(timeout=timeout)
        errs = [err0] + [p.communicate(timeout=60)[1] for p in procs[1:]]
    finally:
        for p in procs:
            p.kill()
    bad = [(i, e[-2000:]) for i, (p, e) in enumerate(zip(procs, errs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"workers failed: {bad}")
    for line in reversed(out.strip().split("\n")):
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON from worker 0: {out[-500:]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seqs-per-device", type=int, default=2)
    ap.add_argument("--size", default="default")
    ap.add_argument("--cores-per-worker", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run the workers on the CPU (default: the "
                         "card)")
    args = ap.parse_args(argv)

    cores = sorted(os.sched_getaffinity(0))
    if args.cores_per_worker:
        cores = cores[:args.cores_per_worker * args.procs]
    base = run_workers(1, args, cores[:max(1, len(cores) // args.procs)])
    cluster = run_workers(args.procs, args, cores)
    fps1 = base["weak_scaling"][0]["fps"]
    fpsN = cluster["weak_scaling"][0]["fps"]
    shared = cluster["device"] == "cuda" and cluster["cards"] < args.procs
    result = {
        "hosts": args.procs, "fps_1host": fps1, "fps_nhosts": fpsN,
        "scaling_efficiency": fpsN / (args.procs * fps1),
        "multihost": cluster["multihost"],
        "hot_loop_collectives": max(
            base["weak_scaling"][0]["hot_loop_collectives"],
            cluster["weak_scaling"][0]["hot_loop_collectives"]),
        "finite": (base["weak_scaling"][0]["finite"]
                   and cluster["weak_scaling"][0]["finite"]),
        "device": cluster["device"], "shared_card": shared}
    if shared:
        result["note"] = ("the workers shared one card: this measures "
                          "contention, not scaling")
        print(result["note"], file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
