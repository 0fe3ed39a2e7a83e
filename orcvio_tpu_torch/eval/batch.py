"""Batch evaluation: many sequences x config variants -> a markdown table.

Counterpart of ``orcvio_tpu/eval/batch.py`` (the reference's evaluator is
``python_scripts/trajectory_eval/batch_run_euroc.py``, a serial loop over
rosbags): sequences are EuRoC directories (tracker and filter, through
the port's own readers) or synthetic seeds (the filter on simulated
tracks), and a batch of synthetic sequences runs as one vmapped replay
(``parallel/replay.py``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _synthetic_start(cfg, sim, dtype, device):
    """(state, frames, gt_p, gt_R): sim's frames and a filter state at
    the ground truth of t = 0 with a 1e-6 prior on the IMU leg, as the JAX
    package's run_synthetic_case starts."""
    from ..dataio.synthetic import initialized_run, generate

    st, frames, _ = initialized_run(cfg, sim, dtype, device)
    d = np.asarray(cfg.initial_cov_diag(), np.float64)
    d[:15] = 1e-6
    st = st.replace(P=torch.diag(torch.as_tensor(d)).to(device, dtype))
    gt = generate(sim, dtype=torch.float64, device="cpu")
    return st, frames, gt.gt_p.numpy(), gt.gt_R.numpy()


def _metrics(p, R, gt_p, gt_R, n_update):
    """The per-sequence metrics of the JAX package's evaluator."""
    from ..math import so3

    err = np.linalg.norm(p - gt_p, axis=1)
    Rrel = torch.as_tensor(np.swapaxes(R, -1, -2) @ gt_R)
    rot_err = np.degrees(torch.linalg.norm(so3.log(Rrel), dim=-1).numpy())
    return {"rmse_pos_m": float(np.sqrt((err**2).mean())),
            "rmse_rot_deg": float(np.sqrt((rot_err**2).mean())),
            "final_err_m": float(err[-1]),
            "updates": int(np.asarray(n_update).sum())}


def run_synthetic_case(cfg, sim, dtype=None, device=None):
    """One synthetic sequence through the filter; returns the metrics.

    dtype: float32 unless given; device: the card unless given."""
    from .. import no_tf32, resolve_device
    from ..filter.pipeline import build_chi2_table, run_sequence

    device = resolve_device(device)
    no_tf32()
    dtype = dtype or torch.float32
    st, frames, gt_p, gt_R = _synthetic_start(cfg, sim, dtype, device)
    _, outs = run_sequence(cfg, st, frames,
                           build_chi2_table(cfg, dtype, device))
    return _metrics(outs.p.double().cpu().numpy(),
                    outs.R.double().cpu().numpy(), gt_p, gt_R,
                    outs.n_update_features.cpu().numpy())


def run_euroc_case(cfg, tc, seq_dir: str, max_frames: int = 0, device=None):
    """One EuRoC sequence through the tracker and the filter (the host
    loop, run_vio.run_image_sequence) from the port's reader (the native
    loader where it builds, else the Python PNG reader); returns fps and,
    with groundtruth, the posyaw-aligned ATE. Times are rebased to the
    sequence's start, as run_vio does (float32 holds no EuRoC epoch)."""
    from .. import resolve_device
    from ..math import quat
    from ..run_vio import open_sequence, run_image_sequence
    from .trajectory import ate

    device = resolve_device(device)
    _, seq, (imu_t, gyro, acc, mask), get_image = open_sequence(
        seq_dir, cfg.imu_slab, cfg.td)
    K = len(seq.cam_t) if not max_frames else min(max_frames, len(seq.cam_t))
    t_origin = float(seq.cam_t[0]) - 1.0
    cam_t = np.asarray(seq.cam_t[:K], np.float64) - t_origin
    imu_t = imu_t - t_origin * (imu_t != 0.0)
    res = run_image_sequence(
        cfg, tc, lambda k: np.asarray(get_image(k), np.float32), cam_t,
        imu_t[:K], gyro[:K], acc[:K], mask[:K], np.eye(3), np.zeros(3),
        device=device)
    out = {"fps": res["fps"]}
    if seq.gt_t is not None:
        q = quat.from_rotation(torch.as_tensor(res["R"],
                                               dtype=torch.float64)).numpy()
        m = ate(res["t"], res["p"], q, seq.gt_t - t_origin, seq.gt_p,
                seq.gt_q, alignment="posyaw")
        out.update(rmse_pos_m=m["rmse_trans"], rmse_rot_deg=m["rmse_rot_deg"])
    return out


def markdown_table(results: Dict[str, Dict[str, Dict]],
                   metrics=("rmse_rot_deg", "rmse_pos_m")) -> str:
    """results[variant][sequence] = metrics dict -> the reference's table
    layout (eval_results/orcvio_vs_larvio/orcvio_vs_larvio_euroc.md): a row
    a variant, a column a sequence holding "rot, pos", and the average."""
    variants = list(results)
    seqs = sorted({s for v in results.values() for s in v})
    lines = ["| variant | " + " | ".join(seqs) + " | avg |",
             "|---|" + "---|" * (len(seqs) + 1)]
    for v in variants:
        cells = []
        acc = np.zeros(len(metrics))
        n = 0
        for s in seqs:
            m = results[v].get(s)
            if m is None:
                cells.append("-")
                continue
            vals = [m.get(k, float("nan")) for k in metrics]
            acc += np.asarray(vals)
            n += 1
            cells.append(", ".join(f"{x:.2f}" for x in vals))
        avg = ", ".join(f"{x:.2f}" for x in (acc / max(n, 1)))
        lines.append(f"| {v} | " + " | ".join(cells) + f" | **{avg}** |")
    return "\n".join(lines)


def run_synthetic_batch_vmap(cfg, sims, dtype=None, device=None):
    """Every sequence through one batched replay: the states and frames
    stacked on a leading axis and each frame's step vmapped over it
    (``parallel/replay.py:sharded_replay_fn`` on one device).

    sims: SimConfigs sharing their shapes (n_frames, max_obs, imu_slab).
    Returns a metrics dict a sequence, as run_synthetic_case's."""
    from .. import no_tf32, resolve_device
    from ..filter.pipeline import FrameInput, build_chi2_table
    from ..parallel.replay import sharded_replay_fn
    from ..tree import tree_stack

    device = resolve_device(device)
    no_tf32()
    dtype = dtype or torch.float32
    starts = [_synthetic_start(cfg, sim, dtype, device) for sim in sims]
    states = tree_stack([s[0] for s in starts])
    frames = FrameInput(*(torch.stack(xs) for xs in
                          zip(*(s[1] for s in starts))))
    _, outs = sharded_replay_fn(cfg, [device])(
        states, frames, build_chi2_table(cfg, dtype, device))
    p = outs.p.double().cpu().numpy()
    R = outs.R.double().cpu().numpy()
    n = outs.n_update_features.cpu().numpy()
    return [_metrics(p[i], R[i], gt_p, gt_R, n[i])
            for i, (_, _, gt_p, gt_R) in enumerate(starts)]


def batch_run_synthetic(variants: Dict[str, dict], seeds: List[int],
                        base_cfg=None, sim_kw=None, use_vmap: bool = False,
                        device=None):
    """variants x seeds on synthetic data (the batch_run_euroc analogue)."""
    from ..config.core import FilterConfig
    from ..dataio.synthetic import SimConfig

    base_cfg = base_cfg or {}
    sim_kw = sim_kw or {}
    results = {}
    for name, overrides in variants.items():
        cfg = FilterConfig(**{**base_cfg, **overrides})
        sims = [SimConfig(**{**sim_kw, "seed": seed}) for seed in seeds]
        if use_vmap:
            per_seq = run_synthetic_batch_vmap(cfg, sims, device=device)
        else:
            per_seq = [run_synthetic_case(cfg, sim, device=device)
                       for sim in sims]
        results[name] = {f"seq{s}": m for s, m in zip(seeds, per_seq)}
    return results
