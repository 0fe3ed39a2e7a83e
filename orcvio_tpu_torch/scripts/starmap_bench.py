"""StarMap inference throughput: the keypoint network of the object path
in a timed loop.

Counterpart of ``scripts/starmap_bench.py``: ``detect_keypoints`` (the
network, then the peak extraction, covariances and part merge) on M = 4
crops a frame, the reference's per-frame box budget, batched through the
network as one (4, 3, 96, 96) call, over T = 100 frames whose crops all
differ. Times come from CUDA events around the whole loop, after a
warm-up pass; on the card the kernels one frame launches are counted with
``torch.profiler``. Prints one JSON line: ms a frame, frames/s, crops/s
and kernels a crop.

    python -m orcvio_tpu_torch.scripts.starmap_bench [--device cpu] [--frames T]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..dataio.render_object import CAR_KEYPOINTS
from ..models.starmap import detect_keypoints, load_pretrained

M = 4     # boxes a frame (the reference's per-frame budget)
T = 100   # frames a timed pass


def kernels_per_call(fn, device):
    """CUDA kernels one call of `fn` launches (None off the card)."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def run(device=None, frames: int = T, seed: int = 0) -> dict:
    device = resolve_device(device)
    model, meta = load_pretrained(device=device)
    size = int(meta["input_size"])
    canon = torch.as_tensor(CAR_KEYPOINTS, dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    crops = torch.as_tensor(rng.uniform(0, 1, (frames, M, 3, size, size)),
                            dtype=torch.float32, device=device)

    def one_pass():
        acc = torch.zeros((), device=device)
        for k in range(frames):
            out = detect_keypoints(model, crops[k], canon)
            acc = acc + (out["kp_xy"] ** 2).sum()  # every frame is used
        return acc

    one_pass()  # warm-up: cuDNN's algorithm choice, allocator
    cuda = device.type == "cuda"
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        e0.record()
    t0 = time.perf_counter()
    acc = one_pass()
    if cuda:
        e1.record()
        torch.cuda.synchronize(device)
        secs = e0.elapsed_time(e1) / 1e3
    else:
        secs = time.perf_counter() - t0
    launches = kernels_per_call(lambda: detect_keypoints(model, crops[0],
                                                         canon), device)
    return {"input_size": size, "boxes_per_frame": M, "frames_timed": frames,
            "ms_per_frame": 1e3 * secs / frames,
            "frames_per_sec": frames / secs,
            "crops_per_sec": M * frames / secs,
            "kernels_per_crop": None if launches is None else launches / M,
            "finite": bool(torch.isfinite(acc)),
            "clock": "CUDA events" if cuda else "host"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--frames", type=int, default=T)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.frames)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
