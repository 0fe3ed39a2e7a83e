"""The flag variants through the port's command, and the JAX package's
figures that chip_smoke.py and the flag matrix hold the card to.

* run_vio.main --device cpu --staged on EuRoC bytes from the port's writer
  (320x240, a 1.2 s static start) with a config.yaml written with the
  ``orcvio_prop`` overrides (use_larvio_flag 0, use_left_perturbation_flag
  1): the command reads the flags, initializes statically and runs the
  filter under them, and its TUM file reads back.
* FilterConfig()'s flags (the JAX package's defaults: OrcVIO propagation,
  left perturbation, Euler Phi, no ZUPT, pure MSCKF) at the filter
  fixture's capacities: 60 frames of filter_step against the JAX
  package's (tests/flag_runs.py), within 1e-8, identical decisions.

Run as a script (CPU):

    python tests/test_torch_flags_replay.py --jax-flag-figures

runs the JAX package's tracker once over the first 84 frames of
chip_smoke.py's end-to-end stream (the port's make_stream on the CPU, cut
from its 300 frames), in float32 as bench.py runs it, then its vio run_vio
per variant of orcvio_tpu_torch/eval/bench_setup.py:VARIANTS in float32,
and prints the init frame, the position error at frame 39 after aligning
the pose at init (chip_smoke.pose_error_after_init), finiteness and the
first non-finite frame; then chip_smoke.FLIGHT_VARIANTS once more with the
filter in float64, and their position error at frame 83 (in flight),
updates after frame 39 and, for the Schmidt variants, their first
demotion and covariance blocks: chip_smoke.py's JAX_FLAGS (``--names a,b`` runs
those variants alone). With ``--jax-flag-matrix [--frames N] [--rows
a,b]`` it runs the flag matrix's rows (flag_matrix.ROWS) over the whole
300-frame stream instead, the filter in
float32, and prints each row's ATE (posyaw, all frames):
flag_matrix.JAX_MATRIX.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from orcvio_tpu_torch import run_vio as prun  # noqa: E402
from orcvio_tpu_torch.dataio import euroc_writer as pwriter  # noqa: E402
from orcvio_tpu_torch.dataio import synthetic as psyn  # noqa: E402
from orcvio_tpu_torch.dataio.euroc import read_tum  # noqa: E402
from orcvio_tpu_torch.eval import staged as pstaged  # noqa: E402
from orcvio_tpu_torch.eval import bench_setup as bs  # noqa: E402
from orcvio_tpu_torch.scripts import flag_matrix  # noqa: E402
import flag_runs as fr  # noqa: E402

torch.set_num_threads(1)

T = 30


@pytest.fixture(scope="module")
def prop_bytes(tmp_path_factory):
    d = tmp_path_factory.mktemp("orcvio_prop")
    sim = psyn.SimConfig(n_frames=T, **{**bs.BENCH_SIM, "static_time": 1.2})
    wc = pwriter.WriterConfig(cam=pwriter.CameraModel(
        width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0),
        tex_size=512)
    pwriter.write_euroc_dataset(str(d), sim, wc, device="cpu")
    pwriter.write_reference_config(
        str(d / "config.yaml"), sim, wc, max_features_num=48, min_distance=10,
        use_larvio_flag=0, use_left_perturbation_flag=1, static_image_num=10)
    return d


def test_main_runs_orcvio_prop_config_on_cpu(prop_bytes, tmp_path, monkeypatch,
                                             capsys):
    seen = []
    build = pstaged.make_e2e_replay

    def spy(cfg, *a, **kw):
        seen.append(cfg)
        return build(cfg, *a, **kw)

    monkeypatch.setattr(pstaged, "make_e2e_replay", spy)
    out = tmp_path / "traj.txt"
    summary = prun.main(["--euroc", str(prop_bytes), "--device", "cpu",
                         "--out", str(out), "--staged"])
    assert "ATE posyaw" in capsys.readouterr().out
    (cfg,) = seen
    assert not cfg.use_larvio and cfg.use_left_perturbation
    assert cfg.use_closed_form_cov_prop and cfg.if_zupt
    res = summary["result"]
    k0 = cs.first_true(res["initialized"])
    assert k0 is not None and k0 < T - 5, "static init, then the filter"
    assert np.isfinite(res["p"]).all() and np.isfinite(res["R"]).all()
    t, p, _ = read_tum(str(out))
    assert t.shape == (T,)
    np.testing.assert_allclose(p, res["p"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("field", ["p", "R", "v"])
def test_jax_default_flags_match_jax(field):
    """FilterConfig()'s flags (the JAX package's defaults) at the filter
    fixture's capacities: 60 frames of filter_step, p, R, v within 1e-8."""
    fr.check_pose("jax_defaults", field)


def test_jax_default_flags_decisions_identical():
    fr.check_decisions("jax_defaults")
    r = fr.run("jax_defaults")
    for pkg in ("jax", "port"):
        assert r[pkg]["out"].n_update_features.sum() > 0
        assert r[pkg]["final"]["P"].shape == (22 + 6 * 8,) * 2


def jax_flag_runs(n_frames, runs):
    """The JAX package on the CPU over the first n_frames of
    chip_smoke.py's end-to-end stream: its tracker once in float32, then
    its vio run_vio per (variant, dtype) of `runs` (the stream's times and
    IMU staged in the dtype). {(name, dtype): (p, R, v, n_upd, final P,
    per frame whether a Schmidt nuisance slot is in use)} and the
    stream."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64",
                      any(dtype == "float64" for _, dtype in runs))
    from orcvio_tpu import vio as jvio
    from orcvio_tpu.config.core import FilterConfig
    from orcvio_tpu.eval import staged as jstaged
    from orcvio_tpu.filter.pipeline import build_chi2_table
    from orcvio_tpu.frontend.tracker import TrackerConfig, TrackerState

    wc = pwriter.WriterConfig()
    st = pwriter.make_stream(psyn.SimConfig(n_frames=cs.E2E_FRAMES,
                                            **bs.BENCH_SIM), wc, device="cpu")
    inputs = [x[:n_frames] for x in bs.bench_inputs(st)]
    tc = TrackerConfig(**bs.TRACKER, K=wc.cam.K)
    scan = jax.jit(jstaged.make_tracker_scan(tc, pwriter.R_B2C_DOWN,
                                             jnp.float32))
    _, tracked = scan(TrackerState.create(tc, jnp.float32),
                      jstaged.stage_sequence(*inputs, jnp.float32))
    out = {}
    for name, dtype in runs:
        t0 = time.perf_counter()
        dt = getattr(jnp, dtype)
        imu = jstaged.stage_sequence(*inputs, dt)
        frames = tracked._replace(t=imu.frame_ts, imu_t=imu.imu_t,
                                  imu_gyro=imu.imu_gyro, imu_acc=imu.imu_acc,
                                  uvs=tracked.uvs.astype(dt),
                                  uv_vels=tracked.uv_vels.astype(dt))
        cfg = FilterConfig(**{**bs.BENCH_FILTER, **bs.VARIANTS.get(name, {})})
        vs = jvio.VioState.create(cfg, tc.capacity, dt)
        vs = vs.replace(filter=vs.filter.replace(
            R_b2c=jnp.asarray(pwriter.R_B2C_DOWN, dt),
            t_c_b=jnp.asarray(wc.t_c_b, dt)))
        chi2 = build_chi2_table(cfg, dt)

        def step(s, f, cfg=cfg, chi2=chi2):
            s, o = jvio.vio_step(cfg, s, f, chi2)
            return s, (o, jnp.any(s.filter.nui.valid))

        fs, (o, nui) = jax.jit(lambda s, f: jax.lax.scan(step, s, f))(
            vs, frames)
        out[name, dtype] = tuple(np.asarray(x, np.float64) for x in (
            o.p, o.R, o.v, o.n_update_features, fs.filter.P)) + (
            np.asarray(nui),)
        print(f"{name} {dtype}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return out, st


def init_frame(R):
    moved = np.abs(R - np.eye(3)).reshape(len(R), -1).max(1) > 0
    return int(np.argmax(moved)) if moved.any() else None


def first_nonfinite(*xs):
    """The first frame where any of the per-frame arrays xs is not
    finite, or None."""
    ok = np.all([np.isfinite(x.reshape(len(x), -1)).all(1) for x in xs], 0)
    return None if ok.all() else int(np.argmin(ok))


def jax_flag_figures(names=None):
    """Per variant, its filter in float32 over the first cs.FLAG_FRAMES
    frames: the init frame, the position error at the last of them,
    whether p, R and v stayed finite there, the first frame whose pose is
    not finite and the update count; for cs.FLIGHT_VARIANTS, their filter
    in float64 to frame cs.FLIGHT_FRAMES - 1 (in flight): the init frame,
    the position error there and the updates after frame
    cs.FLAG_FRAMES - 1, and for the Schmidt variants the first frame that
    holds a nuisance clone and cs.schmidt_blocks of the last frame's P.
    `names`: the variants to run (default all)."""
    n, nf = cs.FLAG_FRAMES, cs.FLIGHT_FRAMES
    names = list(bs.VARIANTS) if names is None else names
    runs, st = jax_flag_runs(nf, [(name, "float32") for name in names]
                             + [(name, "float64") for name in names
                                if name in cs.FLIGHT_VARIANTS])
    figs = {}
    for (name, dtype), (p, R, v, n_upd, P, nui) in runs.items():
        k0 = init_frame(R)
        bad = first_nonfinite(p, R, v)
        if dtype == "float32":
            bad = bad if bad is not None and bad < n else None
            err = (cs.pose_error_after_init(p, R, st.gt_p, st.gt_R, k0, n - 1)
                   if k0 is not None and bad is None else None)
            figs[name] = {"init_frame": k0, "pos_err_m": err,
                          "finite": bad is None,
                          "first_nonfinite_frame": bad,
                          "n_upd_total": int(n_upd[:n].sum())}
        else:
            figs[name]["flight"] = {
                "init_frame": k0,
                "pos_err_m": (cs.pose_error_after_init(
                    p, R, st.gt_p, st.gt_R, k0, nf - 1)
                    if k0 is not None and bad is None else None),
                "finite": bad is None and bool(np.isfinite(P).all()),
                "n_upd": int(n_upd[n:].sum())}
            if "schmidt" in name:
                figs[name]["flight"].update(
                    first_demotion_frame=cs.first_true(nui),
                    **cs.schmidt_blocks(P, bs.VARIANTS[name]["nuisance_cap"]))
    return figs


def jax_flag_matrix(n, rows=flag_matrix.ROWS):
    from orcvio_tpu.eval.trajectory import ate
    from orcvio_tpu_torch.math import quat

    runs, st = jax_flag_runs(n, [(row, "float32") for row in rows])
    ft = np.asarray(st.frame_ts)[:n]
    q_gt = quat.from_rotation(torch.as_tensor(st.gt_R[:n])).numpy()
    figs = {}
    for (name, _), (p, R, v, n_upd, P, _) in runs.items():
        q = quat.from_rotation(torch.as_tensor(R)).numpy()
        try:
            m = ate(ft, p, q, ft, st.gt_p[:n], q_gt, alignment="posyaw")
            a = m["rmse_trans"]
        except ValueError:
            a = None
        figs[name] = {"ate_posyaw_m": a, "init_frame": init_frame(R),
                      "finite": bool(np.isfinite(p).all()),
                      "n_upd_total": int(n_upd.sum())}
    return figs


if __name__ == "__main__":
    if "--jax-flag-figures" in sys.argv:
        print(json.dumps(jax_flag_figures(
            sys.argv[sys.argv.index("--names") + 1].split(",")
            if "--names" in sys.argv else None)))
    elif "--jax-flag-matrix" in sys.argv:
        n = (int(sys.argv[sys.argv.index("--frames") + 1])
             if "--frames" in sys.argv else cs.E2E_FRAMES)
        rows = (sys.argv[sys.argv.index("--rows") + 1].split(",")
                if "--rows" in sys.argv else flag_matrix.ROWS)
        print(json.dumps({"frames": n, "rows": jax_flag_matrix(n, rows)}))
    else:
        sys.exit("usage: python tests/test_torch_flags_replay.py "
                 "--jax-flag-figures [--names a,b] | --jax-flag-matrix "
                 "[--frames N] [--rows a,b]")
