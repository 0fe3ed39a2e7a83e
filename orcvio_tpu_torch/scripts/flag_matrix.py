"""The flag matrix on the card: the bench flags and some of the filter's
flag variants (``eval/bench_setup.py:VARIANTS``) over the bench stream.

Run as a file from the checkout's root, on the card:

    python orcvio_tpu_torch/scripts/flag_matrix.py [--frames N]
        [--rows base,orcvio_prop,...] [--dtype float32|float64]
        [--set key=value ...]

it makes the end-to-end stream of ``chip_smoke.py`` (BENCH_SIM as the
EuRoC writer renders it, ``make_stream`` on the card) cut to N frames (300),
runs the tracker over it once (float32: the LK kernels take float32), and
then each row's filter through ``vio.vio_step`` in the given dtype (the
stream's times and IMU staged in that dtype), with the row's flags and the
``--set`` overrides (``joseph_form=1``, say). Per row it prints one JSON
line: the init frame, ATE (posyaw, all frames) beside the JAX package's
on the same stream (CPU, float32, ``JAX_MATRIX``, at 300 frames), or the
first frame whose pose is not finite, the update and ZUPT counts, the
filter's ms per frame on the host's clock, and K4's launches.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

# the flag matrix's rows: the bench flags, the PARITY.md rows and the IMU
# intrinsics and Schmidt variants
ROWS = ("base", "orcvio_prop", "left_perturb", "no_zupt", "pure_msckf",
        "hybrid_3d", "calib_imu", "schmidt", "schmidt_ref", "calib_schmidt")
# The JAX package on the same 300 frames, float32 on a CPU, from `python
# tests/test_torch_flags_replay.py --jax-flag-matrix`: ATE posyaw (m).
JAX_MATRIX = {
    "base": 0.051326269112411234,
    "orcvio_prop": 0.04541564927565985,
    "left_perturb": 0.051326269112411234,
    "no_zupt": 0.07445422998563328,
    "pure_msckf": 0.0454750267293697,
    "hybrid_3d": 0.06885454181388655,
    "calib_imu": 0.06887828861335617,
    "schmidt": 0.05666362175857566,
    "schmidt_ref": 0.05667747022587911,
    "calib_schmidt": 0.06358845060052876}


def _value(text):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(text.lower(), text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--set", action="append", default=[],
                    help="a FilterConfig override key=value, for every row")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    ap.add_argument("--log-every", type=int, default=0,
                    help="print progress every this many frames")
    args = ap.parse_args(argv)

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("flag_matrix: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from orcvio_tpu_torch import no_tf32
    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio import synthetic as syn
    from orcvio_tpu_torch.dataio.euroc_writer import (R_B2C_DOWN, WriterConfig,
                                                      make_stream)
    from orcvio_tpu_torch.eval.bench_setup import (
        BENCH_FILTER, BENCH_SIM, TRACKER, VARIANTS, bench_inputs, gpu_line)
    from orcvio_tpu_torch.eval.staged import make_tracker_scan, stage_sequence
    from orcvio_tpu_torch.eval.trajectory import ate
    from orcvio_tpu_torch.filter.pipeline import FrameInput, build_chi2_table
    from orcvio_tpu_torch.frontend.tracker import TrackerConfig, TrackerState
    from orcvio_tpu_torch.math import quat
    from orcvio_tpu_torch.ops import _build
    from orcvio_tpu_torch.ops.cov_update import cov_update
    from orcvio_tpu_torch.vio import VioState, vio_step

    no_tf32()
    dtype = getattr(torch, args.dtype)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    overrides = {k: _value(v) for k, v in overrides.items()}
    t0 = time.perf_counter()
    if dev.type == "cuda":
        print(gpu_line(), flush=True)
        _build.build(_build.SOURCES)
    wc = WriterConfig()
    n = args.frames
    st = make_stream(syn.SimConfig(n_frames=n, **BENCH_SIM), wc, device=dev)
    inputs = bench_inputs(st)
    tc = TrackerConfig(**TRACKER, K=wc.cam.K)
    scan = make_tracker_scan(tc, R_B2C_DOWN, torch.float32, device=dev)
    _, tracked = scan(TrackerState.create(tc, torch.float32, seed=0,
                                          device=dev),
                      stage_sequence(*inputs, torch.float32, device=dev))
    # the filter's times and IMU in its own dtype
    imu = stage_sequence(*inputs, dtype, device=dev)
    frames = FrameInput(t=imu.frame_ts, imu_t=imu.imu_t,
                        imu_gyro=imu.imu_gyro, imu_acc=imu.imu_acc,
                        imu_mask=imu.imu_mask, fids=tracked.fids,
                        uvs=tracked.uvs.to(dtype),
                        uv_vels=tracked.uv_vels.to(dtype),
                        meas_mask=tracked.meas_mask)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    print(json.dumps({"setup_s": time.perf_counter() - t0, "frames": n,
                      "dtype": args.dtype, "set": overrides}), flush=True)

    q_gt = quat.from_rotation(torch.as_tensor(st.gt_R)).numpy()
    R_b2c = torch.as_tensor(R_B2C_DOWN, dtype=dtype, device=dev)
    t_c_b = torch.as_tensor(wc.t_c_b, dtype=dtype, device=dev)
    for row in args.rows.split(","):
        cfg = FilterConfig(**{**BENCH_FILTER, **VARIANTS.get(row, {}),
                              **overrides})
        chi2 = build_chi2_table(cfg, dtype, dev)
        vs = VioState.create(cfg, tc.capacity, dtype, device=dev)
        vs = vs.replace(filter=vs.filter.replace(R_b2c=R_b2c, t_c_b=t_c_b))
        cov_update.launches = 0
        outs = []
        t0 = time.perf_counter()
        for k in range(n):
            vs, out = vio_step(cfg, vs, FrameInput(*(x[k] for x in frames)),
                               chi2)
            outs.append(out)
            if args.log_every and (k + 1) % args.log_every == 0:
                print(json.dumps({"row": row, "frame": k + 1,
                                  "p": out.p.tolist(),
                                  "s": time.perf_counter() - t0}), flush=True)
        sync()
        secs = time.perf_counter() - t0
        p = torch.stack([o.p for o in outs]).double().cpu().numpy()
        R = torch.stack([o.R for o in outs]).double().cpu()
        ok = np.isfinite(p).all(axis=1) & np.isfinite(R.numpy()).reshape(
            n, -1).all(axis=1)
        bad = None if ok.all() else int(np.argmin(ok))
        moved = np.abs(R.numpy() - np.eye(3)).reshape(n, -1).max(1) > 0
        k0 = int(np.argmax(moved)) if moved.any() else None
        ft = np.asarray(st.frame_ts)
        last = n if bad is None else bad  # ATE over the finite frames
        try:
            m = ate(ft[:last], p[:last],
                    quat.from_rotation(R[:last]).numpy(), ft[:last],
                    st.gt_p[:last], q_gt[:last], "posyaw")
            a = m["rmse_trans"]
        except ValueError:
            a = None
        print(json.dumps({
            "row": row, "frames": n, "dtype": args.dtype, "set": overrides,
            "init_frame": k0, "ate_posyaw_m": a if bad is None else None,
            "first_nonfinite_frame": bad,
            "ate_posyaw_m_before_nonfinite": a if bad is not None else None,
            "jax_ate_posyaw_m": (JAX_MATRIX.get(row) if n == 300
                                 and args.dtype == "float32" and not overrides
                                 else None),
            "n_upd_total": int(sum(int(o.n_update_features) for o in outs)),
            "zupt_frames": int(sum(bool(o.zupt) for o in outs)),
            "k4_launches": cov_update.launches,
            "ms_per_frame": secs * 1e3 / n, "D": cfg.state_dim}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
