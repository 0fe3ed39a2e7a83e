"""K2's and K3's device times at level 0 of the bench front end, for this
checkout or another one.

    python orcvio_tpu_torch/scripts/lk_times.py [--root DIR]

Uses the ``orcvio_tpu_torch`` package under DIR (default: the checkout
that holds this script) on one seeded frame pair (``level_pair``: a
480x752 texture and its shift by (1.3, -0.7) px, padded to (560, 896)),
200 features, P = 15, 10 steps, float32. Times K2 (``lk_level_src`` on the
levels in place and ``lk_level_fused`` on the windows K1 cuts, eps 0.01,
starts within 0.5 px of the true position) and K3 (``lk_iterate_fused`` on
the windows and, where the package has it, ``lk_iterate_src`` on the level,
with the template of ``klt._template``), each the median of 30 CUDA-event
timed calls with the stream kept busy, as chip_smoke.py times its kernels,
and gives a hash of each output's bytes, so that two checkouts can be
shown to give the same bits. Prints one JSON line. To compare two versions
on one card, unpack the other into a directory and run the script for
each in turn (a, b, b, a). Run it as a file, not with ``-m``: it imports
the package from DIR. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

H, W, N, PATCH, ITERS = 480, 752, 200, 15, 10


def level_pair(n: int = N):
    """Level 0 of the bench front end as numpy float64: a smooth 480x752
    texture, its shift by (1.3, -0.7) px, n positions in the first and
    starts within 0.5 px of their true positions in the second."""
    rng = np.random.default_rng(0)
    base = np.kron(rng.normal(size=(H // 8 + 1, W // 8 + 1)), np.ones((8, 8)))
    k = np.ones(7) / 7.0
    for ax in (0, 1):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                   base)
    img0 = base[:H, :W] * 50.0 + 128.0
    yy, xx = np.mgrid[0:H, 0:W]
    x = np.clip(xx - 1.3, 0, W - 1.001)
    y = np.clip(yy + 0.7, 0, H - 1.001)
    ix, iy = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - ix, y - iy
    img1 = ((1 - fy) * ((1 - fx) * img0[iy, ix] + fx * img0[iy, ix + 1])
            + fy * ((1 - fx) * img0[iy + 1, ix] + fx * img0[iy + 1, ix + 1]))
    xy = rng.uniform([20, 20], [W - 20, H - 20], (n, 2))
    p1 = xy + np.array([1.3, -0.7]) + rng.uniform(-0.5, 0.5, (n, 2))
    return img0, img1, xy, p1


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


def _timed(fn) -> dict:
    out = fn()
    torch.cuda.synchronize()
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    return {"ms": _event_ms(fn), "sha256": digest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lk_times: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from orcvio_tpu_torch.frontend import klt
    from orcvio_tpu_torch.ops import lk_pallas as lk
    from orcvio_tpu_torch.ops.window_gather import prepare_image

    dev = torch.device("cuda")
    img0, img1, xy, p1 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                          for a in level_pair())
    ai0, ai1 = (prepare_image(im[None], klt.MARGIN) for im in (img0, img1))
    c0, c1 = klt.gather_level(ai0, xy), klt.gather_level(ai1, p1)
    s0 = klt.gather_level(ai0, xy, cut=False)
    s1 = klt.gather_level(ai1, p1, cut=False)
    aux2 = klt._level_aux(c0, c1, xy, p1, PATCH)[0]
    full = klt._template(c0, xy, PATCH)
    tmpl = full[:3]
    aux3 = klt._iterate_aux(c1, full, p1, PATCH)[0]
    rows, lanes = klt.ROWS, 2 * klt.LANES
    out = {
        "k2_level": _timed(lambda: lk.lk_level_src(
            s0.level, s0.offset, s1.level, s1.offset, aux2, ITERS, PATCH,
            0.01, rows, lanes)),
        "k2_windows": _timed(lambda: lk.lk_level_fused(
            c0.win, c1.win, aux2, ITERS, PATCH, 0.01)),
        "k3_windows": _timed(lambda: lk.lk_iterate_fused(
            c1.win, *tmpl, aux3, ITERS, PATCH))}
    if hasattr(lk, "lk_iterate_src"):
        out["k3_level"] = _timed(lambda: lk.lk_iterate_src(
            s1.level, s1.offset, *tmpl, aux3, ITERS, PATCH, rows, lanes))
    print(json.dumps({"lk_times": {"root": args.root, "features": N,
                                   "patch": PATCH, "iters": ITERS, **out}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
