"""K4's device time at the end-to-end replay's three shapes and at the
flag variants' new ones, for this checkout or another one.

    python orcvio_tpu_torch/scripts/k4_shapes.py [--root DIR]

Times ``cov_update(P, K, H, HP)`` of the ``orcvio_tpu_torch`` package under
DIR (default: the checkout that holds this script), with H P given as
``filter/update.py:apply_ekf_update`` passes it, at D = 172 and q = 444,
384 and 9 (the stacked, last-chance and ZUPT updates, one of each a filter
frame), and at the flag variants' (D, q) = (142, 384) (pure MSCKF's
stacked update), (232, 444) (3-d inverse depth's), (172, 172) (the qr
and chol forms'), (196, 444) and (196, 9) (calib_imu's), and with the
nuisance block [nb:, nb:] kept (Schmidt, ``cov_update(..., nb)``) at
(208, 444) and (208, 9) with nb = 172 and (232, 444) and (232, 9) with nb
= 196, float32, on seeded random inputs; beside it the plain version
``cov_update_plain(P, K, H, HP, nb)`` and ``torch.addmm(P, K, HP,
alpha=-1)``, the one cuBLAS call that does most of it. Each time is the
median of 30 CUDA-event timed calls with the stream kept busy, as
chip_smoke.py times its kernels. Prints one JSON line. To compare two versions of K4 on one
card, unpack the other into a directory and run the script for each in
turn (a, b, b, a). Run it as a file, not with ``-m``: it imports the
package from DIR. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import torch

# (D, q, nb): nb = D keeps no block
BENCH_SHAPES = ((172, 444, 172), (172, 384, 172), (172, 9, 172))
SHAPES = BENCH_SHAPES + ((142, 384, 142), (232, 444, 232), (172, 172, 172),
                         (196, 444, 196), (196, 9, 196), (208, 444, 172),
                         (208, 9, 172), (232, 444, 196), (232, 9, 196))


def _event_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_shapes: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from orcvio_tpu_torch.ops.cov_update import cov_update, cov_update_plain

    has_nb = "nb" in inspect.signature(cov_update).parameters

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for D, q, nb in SHAPES:
        rng = np.random.default_rng(q)
        A = rng.normal(size=(D, D))
        P, K, H = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                   for x in (A @ A.T / D, rng.normal(size=(D, q)) * 0.1,
                             rng.normal(size=(q, D)) * 0.1))
        HP = H @ P
        kw = {} if nb == D else {"nb": nb}
        if kw and not has_nb:  # a checkout from before the nb entry
            continue
        out[f"{D},{q},{nb}"] = {
            "kernel_ms": _event_ms(lambda: cov_update(P, K, H, HP, **kw)),
            "plain_ms": _event_ms(lambda: cov_update_plain(P, K, H, HP, **kw)),
            "addmm_ms": _event_ms(lambda: torch.addmm(P, K, HP, alpha=-1))}
    print(json.dumps({"k4_shapes": {
        "root": args.root, "by_shape": out,
        "kernel_ms_per_filter_frame": sum(out[f"{D},{q},{nb}"]["kernel_ms"]
                                          for D, q, nb in BENCH_SHAPES)}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
