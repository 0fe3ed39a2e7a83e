"""The port's tooling (utils/checkpoint.py, utils/profiling.py,
eval/batch.py, eval/plots.py) against the JAX package's.

* tests/test_aux.py's checkpoint and OnlineMetrics cases on the port,
  OnlineMetrics equal to the JAX package's on the same inputs;
  a replay resumed from a checkpoint equal bit for bit to the
  uninterrupted one;
* trace writes a Chrome trace that holds a filter step's stage
  spans; the plots write PNGs;
* markdown_table gives the JAX package's string on the same results;
* run_synthetic_batch_vmap against run_synthetic_case and against the
  JAX package's run_synthetic_case, float64, at
  tests/test_parallel.py::TestVmapBatchEval's size, seeds 3 and 4:
  update counts equal, RMSE within 1e-6 m;
* run_euroc_case on bytes the port's writer makes (the JAX package's
  reads its images with cv2, which the port does without).
"""
import json
import os

import numpy as np
import pytest
import torch

from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.filter.pipeline import (FrameInput, build_chi2_table,
                                              filter_step)
from orcvio_tpu_torch.filter.state import FilterState
from orcvio_tpu_torch.utils.checkpoint import (latest_step, restore_state,
                                               save_state)
from orcvio_tpu_torch.utils.profiling import OnlineMetrics, trace

torch.set_num_threads(1)

BASE = dict(sw_size=8, max_features=60, max_track_len=4, imu_slab=12,
            observation_noise=0.004, tri_translation_threshold=-1.0)
SIM_KW = dict(n_frames=40, n_landmarks=200, max_obs=40, imu_slab=12,
              uv_noise=0.002)


def test_checkpoint_round_trip(tmp_path):
    cfg = FilterConfig(sw_size=4, max_features=8)
    st = FilterState.create(cfg, torch.float32, device="cpu")
    st = st.replace(t=torch.tensor(3.5), P=st.P + 0.123)
    path = str(tmp_path / "ckpt")
    save_state(path, st, step=7)
    save_state(path, st, step=3)
    assert latest_step(path) == 7
    assert latest_step(str(tmp_path / "none")) is None
    st2 = restore_state(path, st, step=7)
    assert float(st2.t) == pytest.approx(3.5)
    assert torch.equal(st2.P, st.P) and st2.P.dtype == torch.float32
    assert torch.equal(st2.features.fid, st.features.fid)
    assert st2.features.fid.dtype == torch.int32
    # a template of another layout is refused
    other = FilterState.create(FilterConfig(sw_size=5, max_features=8),
                               torch.float32, device="cpu")
    with pytest.raises(ValueError):
        restore_state(path, other, step=7)


def test_resumed_replay_is_bit_identical(tmp_path):
    from orcvio_tpu_torch.dataio.synthetic import SimConfig, initialized_run
    from orcvio_tpu_torch.filter.pipeline import run_sequence

    cfg = FilterConfig(**{**BASE, "sw_size": 6, "max_features": 40})
    st, frames, chi2 = initialized_run(
        cfg, SimConfig(**{**SIM_KW, "n_frames": 16, "seed": 3}),
        torch.float64, "cpu")
    end, outs = run_sequence(cfg, st, frames, chi2)
    half = FrameInput(*(x[:8] for x in frames))
    rest = FrameInput(*(x[8:] for x in frames))
    mid, _ = run_sequence(cfg, st, half, chi2)
    save_state(str(tmp_path), mid, step=8)
    template = FilterState.create(cfg, torch.float64, device="cpu")
    end2, outs2 = run_sequence(cfg, restore_state(str(tmp_path), template,
                                                  step=8), rest, chi2)
    assert torch.equal(end2.P, end.P) and torch.equal(end2.imu.p, end.imu.p)
    assert torch.equal(outs2.p, outs.p[8:])
    assert int(outs.n_update_features.sum()) > 0


def _metric_inputs():
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec([0.01, 0, 0]).as_matrix()
    rng = np.random.default_rng(3)
    rows = [(np.asarray([k + 0.1, 0, 0]), R, np.asarray([float(k), 0, 0]),
             np.eye(3), np.eye(3) * 0.01) for k in range(5)]
    rows += [(rng.normal(size=3), Rotation.random(random_state=k).as_matrix(),
              rng.normal(size=3), np.eye(3), None) for k in range(3)]
    return rows


def test_online_metrics_match_jax(tmp_path):
    from orcvio_tpu.utils.profiling import OnlineMetrics as JaxMetrics

    ours, theirs = OnlineMetrics(), JaxMetrics()
    for k, (p, R, pg, Rg, P) in enumerate(_metric_inputs()):
        ours.update(p, R, pg, Rg, P_pos=P)
        theirs.update(p, R, pg, Rg, P_pos=P)
        if k == 4:  # tests/test_aux.py's five rows
            s = ours.summary()
            assert s["rmse_pos_m"] == pytest.approx(0.1, abs=1e-6)
            assert s["rmse_rot_deg"] == pytest.approx(np.degrees(0.01),
                                                      abs=1e-4)
            assert s["nees_pos"] == pytest.approx(1.0, abs=1e-6)
    assert ours.summary() == theirs.summary()
    ours.write(str(tmp_path / "a.txt"))
    theirs.write(str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_trace_writes_a_chrome_trace(tmp_path):
    cfg = FilterConfig(sw_size=4, max_features=8, imu_slab=4)
    st = FilterState.create(cfg, torch.float64, device="cpu")
    S, M = cfg.imu_slab, 8
    z = lambda *shape: torch.zeros(*shape, dtype=torch.float64)  # noqa: E731
    frame = FrameInput(t=z(()), imu_t=z(S), imu_gyro=z(S, 3),
                       imu_acc=z(S, 3), imu_mask=torch.zeros(S, dtype=bool),
                       fids=torch.full((M,), -1, dtype=torch.int32),
                       uvs=z(M, 2), uv_vels=z(M, 2),
                       meas_mask=torch.zeros(M, dtype=bool))
    chi2 = build_chi2_table(cfg, torch.float64, device="cpu")
    with trace(str(tmp_path)) as prof:
        filter_step(cfg, st, frame, chi2)
    assert os.path.getsize(prof.path) > 0
    with open(prof.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for stage in ("propagate", "augment", "ingest", "zupt", "classify",
                  "triangulate", "jacobians", "update", "select",
                  "last_chance", "prune"):
        assert f"orcvio::filter.{stage}" in names


def test_plots_write_pngs(tmp_path):
    from orcvio_tpu_torch.eval.plots import plot_object_map, plot_trajectory

    t = np.linspace(0, 5, 50)
    p = np.stack([np.cos(t), np.sin(t), 0.1 * t], 1)
    a = plot_trajectory(str(tmp_path / "traj.png"), t, p, p + 0.01)
    objs = [{"t": [1.0, 2.0, 0.0], "yaw": 0.3, "shape": [2.0, 0.9, 0.7]}]
    b = plot_object_map(str(tmp_path / "map.png"), objs, objs, p_est=p)
    for path in (a, b):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_markdown_table_matches_jax():
    from orcvio_tpu.eval.batch import markdown_table as jax_table
    from orcvio_tpu_torch.eval.batch import markdown_table

    res = {"msckf": {"seq3": {"rmse_rot_deg": 1.234, "rmse_pos_m": 0.05},
                     "seq4": {"rmse_rot_deg": 0.5, "rmse_pos_m": 0.125}},
           "larvio": {"seq4": {"rmse_rot_deg": 2.0, "rmse_pos_m": 0.3}}}
    assert markdown_table(res) == jax_table(res)
    assert "| msckf |" in markdown_table(res)


def test_batch_vmap_matches_serial_and_jax():
    import jax.numpy as jnp

    from orcvio_tpu.config.core import FilterConfig as JaxFilterConfig
    from orcvio_tpu.dataio.synthetic import SimConfig as JaxSim
    from orcvio_tpu.eval.batch import run_synthetic_case as jax_case
    from orcvio_tpu_torch.dataio.synthetic import SimConfig
    from orcvio_tpu_torch.eval.batch import (run_synthetic_batch_vmap,
                                             run_synthetic_case)

    cfg = FilterConfig(**BASE)
    sims = [SimConfig(**{**SIM_KW, "seed": s}) for s in (3, 4)]
    batched = run_synthetic_batch_vmap(cfg, sims, torch.float64, "cpu")
    for sim, got in zip(sims, batched):
        ref = run_synthetic_case(cfg, sim, torch.float64, "cpu")
        jref = jax_case(JaxFilterConfig(**BASE),
                        JaxSim(**{**SIM_KW, "seed": sim.seed}), jnp.float64)
        for other in (ref, jref):
            assert got["updates"] == other["updates"], (sim.seed, got, other)
            for key in ("rmse_pos_m", "final_err_m"):
                assert abs(got[key] - other[key]) < 1e-6, (key, got, other)
            assert abs(got["rmse_rot_deg"] - other["rmse_rot_deg"]) < 1e-4
        assert got["rmse_pos_m"] < 0.3 and got["updates"] > 0


def test_euroc_case_on_written_bytes(tmp_path):
    """run_euroc_case through the port's reader and host loop on 6 frames
    the port's writer makes (160x120): fps and a finite ATE."""
    from orcvio_tpu_torch.dataio import euroc_writer as pwriter
    from orcvio_tpu_torch.dataio.synthetic import SimConfig
    from orcvio_tpu_torch.eval.batch import run_euroc_case
    from orcvio_tpu_torch.eval.bench_setup import BENCH_SIM
    from orcvio_tpu_torch.frontend.tracker import TrackerConfig

    cam = pwriter.CameraModel(width=160, height=120, fx=100.0, fy=100.0,
                              cx=80.0, cy=60.0)
    sim = SimConfig(n_frames=6, **{**BENCH_SIM, "static_time": 0.3})
    pwriter.write_euroc_dataset(str(tmp_path), sim, pwriter.WriterConfig(
        cam=cam, tex_size=512), device="cpu")
    tc = TrackerConfig(height=120, width=160, capacity=32, pyramid_levels=2,
                       grid_rows=4, grid_cols=4, min_distance=8.0,
                       K=(100.0, 100.0, 80.0, 60.0))
    out = run_euroc_case(FilterConfig(sw_size=6, max_features=32,
                                      imu_slab=16), tc, str(tmp_path),
                         max_frames=4, device="cpu")
    assert out["fps"] > 0
    assert np.isfinite(out["rmse_pos_m"]) and np.isfinite(out["rmse_rot_deg"])
