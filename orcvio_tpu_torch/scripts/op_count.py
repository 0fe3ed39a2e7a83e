"""Operations a filter frame issues, for each flag variant, for this
checkout or another one.

    python orcvio_tpu_torch/scripts/op_count.py [--root DIR] [--frames T]

Runs ``filter_step`` of the ``orcvio_tpu_torch`` package under DIR
(default: the checkout that holds this script) on the CPU in float64,
over T frames (default 14) of the port's synthetic sequence
(``dataio/synthetic.py:generate``, 200 landmarks, IMU slab 16), from the
sequence's initial state, with the bench flags and each variant of
``eval/bench_setup.py:VARIANTS`` at a small capacity (8 clones, 48
features, 6 EKF features). It counts the aten operations each frame
dispatches (each is a kernel launch on the card, where the host sets the
pace) and prints one JSON line: per variant the mean count over the
frames from the fifth on, and the final |p| summed, which two checkouts
that compute the same must share. Run it as a file, not with ``-m``: it
imports the package from DIR.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--frames", type=int, default=14)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio import synthetic as syn
    from orcvio_tpu_torch.eval.bench_setup import BENCH_FILTER, VARIANTS
    from orcvio_tpu_torch.filter.pipeline import (FrameInput,
                                                  build_chi2_table,
                                                  filter_step)
    from orcvio_tpu_torch.filter.state import FilterState

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    torch.set_num_threads(1)
    T, d = args.frames, torch.float64
    sim = syn.SimConfig(n_frames=T, n_landmarks=200, max_obs=48,
                        imu_slab=16, seed=0)
    R_b2c = np.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    t_c_b = np.asarray([0.05, 0.02, 0.0])
    frames = syn.generate(sim, R_b2c, t_c_b, d, device="cpu").frames
    R0, p0, v0 = (torch.as_tensor(x).to(d) for x in syn.initial_state_np(sim))
    out = {"frames": T}
    small = dict(sw_size=8, max_features=48, ekf_feature_cap=6)
    for name, over in [("bench", {})] + list(VARIANTS.items()):
        cfg = FilterConfig(**{**BENCH_FILTER, **small, **over})
        st = FilterState.create(cfg, d, device="cpu")
        imu = st.imu.replace(R=R0, p=p0, v=v0)
        st = st.replace(imu=imu, imu_fej_now=imu, imu_old=imu,
                        R_b2c=torch.as_tensor(R_b2c).to(d),
                        t_c_b=torch.as_tensor(t_c_b).to(d),
                        initialized=torch.ones((), dtype=torch.bool))
        chi2 = build_chi2_table(cfg, d, "cpu")
        counts = []
        for k in range(T):
            Count.n = 0
            with Count():
                st, _ = filter_step(cfg, st, FrameInput(
                    *(x[k] for x in frames)), chi2)
            counts.append(Count.n)
        out[name] = {"ops_per_frame": float(np.mean(counts[4:])),
                     "p_abs_sum": float(st.imu.p.abs().sum())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
