"""Operations the staged object replay dispatches a frame, by stage.

    python orcvio_tpu_torch/scripts/object_op_count.py [--frames T]

Runs ``objects/staged.py:make_objects_replay`` at config A
(``eval/object_map_sim.py``: 12 cars, the staged replay's float32
configuration: map capacity 32, finalize budget 1) on the CPU in
float32 over the first T frames (default 60: the first finalizations
fall on frames 22 on), and counts the aten operations each frame
dispatches (each is a kernel launch on the card, where the host sets the
pace), in all and inside each stage: vio_step, SORT (and its auction),
keypoint ingest, the finalization (and in it the initialization and the
LM) and the object update. Prints one JSON line: the mean count a frame
over frames without a finalization and over frames with one, by stage.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from orcvio_tpu_torch.dataio.synthetic import generate
    from orcvio_tpu_torch.eval import object_map_sim as oms
    from orcvio_tpu_torch.filter.pipeline import FrameInput
    from orcvio_tpu_torch.objects import manager, sort, staged
    from orcvio_tpu_torch.vio import VioState

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    stages = {}

    def counted(module, name, key):
        fn = getattr(module, name)

        @functools.wraps(fn)
        def wrap(*a, **kw):
            n0 = Count.n
            out = fn(*a, **kw)
            stages[key] = stages.get(key, 0) + Count.n - n0
            return out

        setattr(module, name, wrap)

    for module, name, key in (
            (staged, "vio_step", "vio_step"), (staged, "sort_step", "sort"),
            (sort, "auction_assign", "auction"), (staged, "ingest", "ingest"),
            (staged, "finalize_object", "finalize"),
            (manager, "object_initialization", "init"),
            (manager, "optimize", "lm"),
            (staged, "object_ekf_update", "object_update")):
        counted(module, name, key)

    torch.set_num_threads(1)
    f32, dev = torch.float32, torch.device("cpu")
    wc = oms.WorldConfig(n_frames=args.frames)
    sim = oms.world_sim(wc)
    ocfg = oms.object_vio_config(wc)
    data = generate(sim, R_b2c=oms.R_B2C, t_c_b=oms.T_C_B, dtype=f32,
                    device=dev)
    dets = oms.detection_stream(wc, oms.make_world(wc), data.gt_R.numpy(),
                                data.gt_p.numpy(),
                                np.random.default_rng(wc.seed + 1))
    stream = staged.ObjectsStream(*(torch.as_tensor(x).to(
        f32 if x.dtype.kind == "f" else None) for x in dets))
    vs = VioState.create(ocfg.filter, sim.max_obs, f32, dev).replace(
        filter=oms.initial_filter_state(ocfg.filter, sim, f32, dev))
    replay = staged.make_objects_replay(ocfg, sim.max_obs, map_capacity=32,
                                        dtype=f32, device=dev)
    carry = replay.init_carry(vs)
    rows = []
    for k in range(args.frames):
        stages.clear()
        Count.n = 0
        with Count():
            carry, _ = replay(carry, FrameInput(*(x[k:k + 1]
                                                  for x in data.frames)),
                              staged.ObjectsStream(*(x[k:k + 1]
                                                     for x in stream)))
        rows.append({"all": Count.n, **stages})
    out = {"frames": args.frames}
    for kind, pick in (("without_finalize", lambda r: "finalize" not in r),
                       ("with_finalize", lambda r: "finalize" in r)):
        sel = [r for r in rows[1:] if pick(r)]  # frame 0 reads the init flag
        keys = sorted({k for r in sel for k in r})
        out[kind] = {"frames": len(sel), **{
            k: float(np.mean([r.get(k, 0) for r in sel])) for k in keys}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
