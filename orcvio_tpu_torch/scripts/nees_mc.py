"""NEES Monte-Carlo of the sequence-parallel gauge-covariance correction.

Counterpart of the JAX repository's ``scripts/nees_mc.py``, on the port
(parallel/temporal.py), with the same protocol: a 120-frame synthetic
trajectory, K = 4 time blocks, float64, the filter started at the ground
truth with a tight (1e-8) prior, so that the unobservable gauge's random
walk dominates the end covariance. For each seed:

* the serial filter's end-position NEES, e^T P_pp^-1 e / 3 (the
  calibration it is held to);
* seq_parallel_replay at n_iters 2 and 3, with and without the per-block
  gauge-covariance correction.

An uncorrected stitch under-covers (NEES above the serial filter's); the
corrected one should land at or below the serial level.

Usage: ``python orcvio_tpu_torch/scripts/nees_mc.py --out FILE [--seeds 6]
[--device cpu]`` (the card unless --device says otherwise). Prints a JSON
line a seed, then the means; writes the whole result to FILE.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from orcvio_tpu_torch import resolve_device  # noqa: E402
from orcvio_tpu_torch.config.core import FilterConfig  # noqa: E402
from orcvio_tpu_torch.dataio.synthetic import (  # noqa: E402
    SimConfig, generate, initialized_run)
from orcvio_tpu_torch.filter.pipeline import run_sequence  # noqa: E402
from orcvio_tpu_torch.parallel.temporal import (  # noqa: E402
    seq_parallel_replay)

CFG_KW = dict(sw_size=10, max_features=80, max_track_len=6, imu_slab=12,
              observation_noise=0.004, tri_translation_threshold=-1.0)
SIM_KW = dict(n_frames=120, n_landmarks=300, max_obs=40, imu_slab=12)
K_BLOCKS = 4


def end_pos_nees(state, gt_p_end):
    e = state.imu.p.double().cpu().numpy() - gt_p_end
    Ppp = state.P[6:9, 6:9].double().cpu().numpy()
    return float(e @ np.linalg.solve(Ppp, e)) / 3.0


def run_seed(seed, device):
    cfg = FilterConfig(**CFG_KW)
    sim = SimConfig(**SIM_KW, seed=seed)
    st, frames, chi2 = initialized_run(cfg, sim, torch.float64, device)
    st = st.replace(P=torch.eye(st.P.shape[0], dtype=torch.float64,
                                device=device) * 1e-8)
    gt_end = generate(sim, dtype=torch.float64, device="cpu").gt_p[-1].numpy()
    out = {}
    end_s, _ = run_sequence(cfg, st, frames, chi2)
    out["serial"] = end_pos_nees(end_s, gt_end)
    for n_iters in (2, 3):
        for corrected in (False, True):
            end_p, _ = seq_parallel_replay(
                cfg, st, frames, chi2, n_blocks=K_BLOCKS, n_iters=n_iters,
                gauge_cov_correction=corrected)
            tag = f"n{n_iters}_{'corrected' if corrected else 'raw'}"
            out[tag] = end_pos_nees(end_p, gt_end)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--out", required=True, help="the JSON file to write")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    per_seed = []
    for s in range(args.seeds):
        r = run_seed(s, device)
        per_seed.append(r)
        print(json.dumps({"seed": s, **r}), flush=True)
    keys = per_seed[0].keys()
    result = {
        "protocol": {
            "frames": SIM_KW["n_frames"], "blocks": K_BLOCKS,
            "seeds": args.seeds, "dtype": "float64",
            "prior": "gt-init, 1e-8 diag", "device": str(device),
            "metric": "end-position NEES / 3 (1.0 = perfectly calibrated)"},
        "mean": {k: float(np.mean([r[k] for r in per_seed])) for k in keys},
        "median": {k: float(np.median([r[k] for r in per_seed]))
                   for k in keys},
        "per_seed": per_seed,
        "seconds": time.perf_counter() - t0,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"wrote": args.out, "mean": result["mean"],
                      "seconds": result["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
