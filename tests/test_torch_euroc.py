"""The port's EuRoC readers, PNG codec and writer against the JAX package's.

On a 160x120 camera, 8 frames written to tmp_path by both writers (the
JAX package's with cv2, float64 on the CPU; the port's with its own codec,
device="cpu"):

* load_euroc and bin_imu_per_frame give arrays equal to the JAX package's
  on the JAX writer's bytes, and load_bench_images equals cv2.imread;
* the decoder equals cv2.imread on the JAX writer's PNGs, on PNGs whose
  rows use each of the five filters, and encode-then-decode is exact;
* the port writer's CSVs parse to the JAX package's numbers within 2e-9
  (its last printed digit; the port differentiates the trajectory in
  closed form, the JAX package with autodiff), with identical timestamps
  and file lists;
* its images equal the JAX package's except at pixels whose float value
  lies within rounding of an integer step: at most 0.1 % of the pixels,
  each off by 1;
* NativeEurocLoader, built from native/euroc_loader.cpp into the port's
  build directory, matches the Python reader (skipped only where g++ or
  libpng is missing);
* write_tum and read_tum round-trip, as the JAX package's read_tum reads.

Run as a script, ``python tests/test_torch_euroc.py --jax-euroc-ate``, it
writes chip_smoke.py's phase-9 streams with the JAX package's writer and
runs the JAX package's run_vio.main on them in float32 on the CPU (some
5 min, 3 GB), printing the figures chip_smoke.py holds the port to. With
``--jax-dynamic-draws [--draws N] [--set key=value ...]`` it reads the
dynamic initializer's accuracy over N RANSAC draws of each package on the
dynamic stream's attempt windows (dynamic_draws).
"""
import json
import os
import shutil
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

cv2 = pytest.importorskip("cv2")

from orcvio_tpu.dataio import euroc as jeuroc  # noqa: E402
from orcvio_tpu.dataio import euroc_writer as jwriter  # noqa: E402
from orcvio_tpu.dataio.synthetic import SimConfig as JaxSim  # noqa: E402
from orcvio_tpu_torch.dataio import _png  # noqa: E402
from orcvio_tpu_torch.dataio import euroc as peuroc  # noqa: E402
from orcvio_tpu_torch.dataio import euroc_writer as pwriter  # noqa: E402
from orcvio_tpu_torch.dataio import native as pnative  # noqa: E402
from orcvio_tpu_torch.dataio.synthetic import SimConfig  # noqa: E402
from orcvio_tpu_torch.eval.staged import load_bench_images  # noqa: E402

torch.set_num_threads(1)

SIM = dict(n_frames=8, frame_hz=20.0, imu_hz=200.0, static_time=0.1,
           ramp_time=0.3, height=4.0, radius=2.5, omega=0.5, seed=11,
           gyro_noise=0.0024, acc_noise=0.028)
CAM = dict(width=160, height=120, fx=98.0, fy=98.0, cx=80.0, cy=60.0)
CSV_TOL = 2e-9
CSVS = ("imu0/data.csv", "cam0/data.csv",
        "state_groundtruth_estimate0/data.csv")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both writers' sequences: {"jax": dir, "port": dir}."""
    root = tmp_path_factory.mktemp("euroc")
    jwriter.write_euroc_dataset(
        str(root / "jax"), JaxSim(**SIM),
        jwriter.WriterConfig(cam=jwriter.CameraModel(**CAM), tex_size=512))
    pwriter.write_euroc_dataset(
        str(root / "port"), SimConfig(**SIM),
        pwriter.WriterConfig(cam=pwriter.CameraModel(**CAM), tex_size=512),
        device="cpu")
    return {"jax": str(root / "jax"), "port": str(root / "port")}


def test_load_euroc_matches_jax(written):
    ours = peuroc.load_euroc(written["jax"])
    theirs = jeuroc.load_euroc(written["jax"])
    assert ours._fields == theirs._fields
    for name in ours._fields:
        a, b = getattr(ours, name), getattr(theirs, name)
        if name == "image_paths":
            assert a == b and len(a) == SIM["n_frames"]
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("slab,td", [(16, 0.0), (4, 0.003)])
def test_bin_imu_per_frame_matches_jax(written, slab, td):
    seq = peuroc.load_euroc(written["jax"])
    if slab == 4:  # too small a slab drops the oldest samples, with a warning
        with pytest.warns(UserWarning, match="dropped"):
            ours = peuroc.bin_imu_per_frame(seq, slab, td)
    else:
        ours = peuroc.bin_imu_per_frame(seq, slab, td)
    with np.testing.suppress_warnings() as sup:
        sup.filter(UserWarning)
        theirs = jeuroc.bin_imu_per_frame(jeuroc.load_euroc(written["jax"]),
                                          slab, td)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[3].sum() > 0


def test_decoder_equals_cv2_on_the_writers_pngs(written):
    paths = peuroc.load_euroc(written["jax"]).image_paths
    for p in paths:
        np.testing.assert_array_equal(_png.read_gray8(p),
                                      cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(
        load_bench_images(paths, CAM["height"], CAM["width"], limit=5),
        np.stack([cv2.imread(p, cv2.IMREAD_GRAYSCALE) for p in paths[:5]]))


def _filtered_png(img, filters):
    """PNG bytes of img with row y filtered by filters[y] (0-4), as libpng
    may choose them, for the decoder to undo."""
    H, W = img.shape
    raw = bytearray()
    prior = np.zeros(W, np.int64)
    for y in range(H):
        row = img[y].astype(np.int64)
        left = np.concatenate([[0], row[:-1]])
        upleft = np.concatenate([[0], prior[:-1]])
        f = filters[y]
        if f == 0:
            pred = np.zeros(W, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb = np.abs(p - left), np.abs(p - prior)
            pc = np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        raw += bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + chunk(b"IEND", b""))


def test_decoder_undoes_all_five_row_filters(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(25, 37), dtype=np.uint8)
    img[10:] = np.clip(np.cumsum(rng.normal(size=(15, 37)) * 9, axis=1)
                       + 128, 0, 255).astype(np.uint8)
    data = _filtered_png(img, [y % 5 for y in range(25)])
    path = tmp_path / "filters.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE),
                                  img)  # the fixture is a valid PNG
    np.testing.assert_array_equal(_png.decode_gray8(data), img)
    with pytest.raises(ValueError, match="CRC"):
        _png.decode_gray8(data[:40] + bytes([data[40] ^ 1]) + data[41:])


@pytest.mark.parametrize("shape", [(1, 1), (7, 300), (120, 160)])
def test_encode_then_decode_is_exact(tmp_path, shape):
    rng = np.random.default_rng(shape[1])
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    _png.write_gray8(path, img)
    np.testing.assert_array_equal(_png.read_gray8(path), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), img)


def _rows(path):
    return Path(path).read_bytes().decode().split("\r\n")


@pytest.mark.parametrize("csv", CSVS)
def test_writer_csvs_match_jax(written, csv):
    ours = _rows(os.path.join(written["port"], "mav0", csv))
    theirs = _rows(os.path.join(written["jax"], "mav0", csv))
    assert not ours[-1].endswith("\n") and ours[-1]  # no trailing newline
    assert len(ours) == len(theirs) and ours[0] == theirs[0]  # header
    a = [r.split(",") for r in ours[1:]]
    b = [r.split(",") for r in theirs[1:]]
    assert [r[0] for r in a] == [r[0] for r in b]  # ns timestamps, exactly
    if csv.startswith("cam0"):
        assert a == b  # file names
        return
    np.testing.assert_allclose(np.asarray(a, float)[:, 1:],
                               np.asarray(b, float)[:, 1:], rtol=0,
                               atol=CSV_TOL)


def test_writer_images_match_jax(written):
    names = sorted(os.listdir(os.path.join(written["jax"], "mav0/cam0/data")))
    assert names == sorted(os.listdir(
        os.path.join(written["port"], "mav0/cam0/data")))
    diffs = []
    for name in names:
        a = cv2.imread(os.path.join(written["jax"], "mav0/cam0/data", name),
                       cv2.IMREAD_GRAYSCALE).astype(int)
        b = _png.read_gray8(os.path.join(written["port"], "mav0/cam0/data",
                                         name)).astype(int)
        diffs.append(np.abs(a - b))
    diffs = np.stack(diffs)
    assert diffs.max() <= 1
    assert (diffs > 0).mean() <= 1e-3, (diffs > 0).sum()


def test_make_stream_is_what_is_written(written):
    """make_stream (phase 5's stream in chip_smoke.py) holds what
    write_euroc_dataset writes: the same frames, the IMU and ground truth
    within the CSVs' last printed digit."""
    wc = pwriter.WriterConfig(cam=pwriter.CameraModel(**CAM), tex_size=512)
    st = pwriter.make_stream(SimConfig(**SIM), wc, device="cpu")
    seq = peuroc.load_euroc(written["port"])
    np.testing.assert_array_equal(
        st.images, load_bench_images(seq.image_paths, CAM["height"],
                                     CAM["width"]))
    t0 = wc.t0_ns * 1e-9
    np.testing.assert_allclose(seq.cam_t - t0, st.frame_ts, rtol=0, atol=1e-6)
    np.testing.assert_allclose(seq.imu_t - t0, st.imu_ts, rtol=0, atol=1e-6)
    for a, b in ((seq.gyro, st.gyro), (seq.acc, st.acc), (seq.gt_p, st.gt_p),
                 (seq.gt_v, st.gt_v)):
        np.testing.assert_allclose(a, b, rtol=0, atol=CSV_TOL)


def test_native_loader_matches_python_reader(written):
    try:
        nat = pnative.NativeEurocLoader(written["port"], prefetch_threads=2)
    except RuntimeError as e:
        if shutil.which("g++") is None or "png.h" in str(e):
            pytest.skip(f"g++ or libpng missing: {e}")
        raise
    assert Path(pnative.build_native()).parent == pnative.BUILD_DIR
    py = peuroc.load_euroc(written["port"])
    np.testing.assert_array_equal(nat.cam_t, py.cam_t)
    for a, b in ((nat.imu_t, py.imu_t), (nat.gyro, py.gyro),
                 (nat.acc, py.acc), (nat.gt_t, py.gt_t), (nat.gt_p, py.gt_p),
                 (nat.gt_q, py.gt_q)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    for a, b in zip(nat.bin_imu(16), peuroc.bin_imu_per_frame(py, 16)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    for k, p in enumerate(py.image_paths):
        np.testing.assert_array_equal(nat.get_image(k), _png.read_gray8(p))
    nat.close()


def test_tum_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    t = 1.4e9 + np.arange(5) * 0.05
    p, q = rng.normal(size=(5, 3)), rng.normal(size=(5, 4))
    path = str(tmp_path / "traj.txt")
    peuroc.write_tum(path, t, p, q)
    ours, theirs = peuroc.read_tum(path), jeuroc.read_tum(path)
    for a, b, c in zip(ours, theirs, (t, p, q)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# --jax-euroc-ate: the JAX package's figures for chip_smoke.py's phase 9
# ---------------------------------------------------------------------------

def _jax_main_run(argv, capture):
    """orcvio_tpu.run_vio.main(argv), with the trajectory result and the
    dynamic attempts it made captured from the functions it calls."""
    import jax
    import orcvio_tpu.eval.staged as jstaged
    import orcvio_tpu.init.dynamic as jdyn
    import orcvio_tpu.run_vio as jrun

    attempts, result = [], {}
    run_seq, make_replay = jrun.run_image_sequence, jstaged.make_e2e_replay
    attempt = jdyn.flexible_dynamic_attempt

    def spy_attempt(cfg, window, R_b2c, t_c_b, key, *a, **kw):
        res = attempt(cfg, window, R_b2c, t_c_b, key, *a, **kw)
        k = int(np.asarray(key).reshape(-1)[-1])  # jax.random.PRNGKey(k)
        attempts.append((k, None if res is None else bool(res.ok)))
        return res

    def spy_run(*a, **kw):
        result.update(run_seq(*a, **kw))
        return result

    def spy_replay(*a, **kw):
        replay = make_replay(*a, **kw)

        def run(*args):  # traced by main's jax.jit: read back by callback
            import jax

            out = replay(*args)
            jax.debug.callback(
                lambda n: result.__setitem__("n_updates", np.asarray(n)),
                out[1]["n_upd"])
            return out
        return run

    jrun.run_image_sequence = spy_run
    jstaged.make_e2e_replay = spy_replay
    jdyn.flexible_dynamic_attempt = spy_attempt
    try:
        jrun.main(argv)
        jax.effects_barrier()
    finally:
        jrun.run_image_sequence = run_seq
        jstaged.make_e2e_replay = make_replay
        jdyn.flexible_dynamic_attempt = attempt
    capture.update(attempts=attempts, n_updates=result.get("n_updates"))


def _figures(seq_dir, tum, from_init=False):
    """ATE (se3 and posyaw) and init frame of a TUM output against the
    sequence's groundtruth; from_init: only the frames from init on."""
    from orcvio_tpu.eval.trajectory import ate

    _, p, q = jeuroc.read_tum(tum)
    seq = jeuroc.load_euroc(seq_dir)
    # row k is frame k; the JAX package's --staged run writes its float32
    # frame times plus the float64 epoch as float32, so the file's own times
    # are not used
    t = seq.cam_t[:len(p)]
    moved = np.abs(q - [0, 0, 0, 1]).max(1) > 0
    k0 = int(np.argmax(moved)) if moved.any() else None
    s = slice(k0 if from_init and k0 is not None else 0, None)
    out = {"init_frame": k0}
    out["ate_m"] = {al: ate(t[s], p[s], q[s], seq.gt_t, seq.gt_p, seq.gt_q,
                            alignment=al)["rmse_trans"]
                    for al in ("se3", "posyaw")}
    return out


def jax_euroc_figures():
    """The JAX package on its own writer's bytes of chip_smoke.py's phase-9
    streams, float32 on the CPU."""
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    import orcvio_tpu.init.dynamic as jdyn
    from orcvio_tpu.dataio.synthetic import SimConfig as JSim

    import chip_smoke as cs
    from orcvio_tpu_torch.run_vio import DYN_EVERY

    # the attempts' math compiled once per window shape instead of op by op
    jdyn.dynamic_initialize = jax.jit(jdyn.dynamic_initialize,
                                      static_argnums=0)
    tmp = tempfile.mkdtemp(prefix="orcvio_jax_euroc_")
    figures = {}
    try:
        for name, n, sim in (("bench", cs.EUROC_FRAMES, cs.BENCH_SIM),
                             ("dynamic", cs.DYN_FRAMES, cs.DYN_SIM)):
            d = os.path.join(tmp, name)
            jsim = JSim(n_frames=n, **sim)
            jwriter.write_euroc_dataset(d, jsim)
            jwriter.write_reference_config(os.path.join(d, "config.yaml"),
                                           jsim, output_dir=d + "/out/")
            runs = (("staged", ["--staged"]), ("host_loop", [])) \
                if name == "bench" else (("dynamic", []),)
            for run, extra in runs:
                tum = os.path.join(tmp, f"{run}.txt")
                cap = {}
                # the bench's runs take its first EUROC_RUN_FRAMES frames,
                # as phase 9's do
                runs_n = cs.EUROC_RUN_FRAMES if name == "bench" else n
                _jax_main_run(["--euroc", d, "--config",
                               os.path.join(d, "config.yaml"), "--out", tum,
                               "--backend", "cpu", "--max-frames",
                               str(runs_n),
                               "--imu-slab", str(cs.BENCH_FILTER["imu_slab"])]
                              + extra, cap)
                fig = _figures(d, tum, from_init=run == "dynamic")
                fig["n_upd_total"] = int(np.asarray(cap["n_updates"]).sum())
                fig["dynamic_attempts"] = cap["attempts"]
                if run == "dynamic":
                    fig["ate_se3_from_init_m"] = fig["ate_m"]["se3"]
                    fig["attempt_window"] = [
                        cap["attempts"][0][0],
                        fig["init_frame"] + DYN_EVERY]
                figures[run] = fig
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    figures.update(dtype="float32", platform="cpu")
    return figures


def _init_errors(res, R_gt, v_gt, cs):
    """[gravity deg, speed error, scale] of a DynamicInitResult of either
    package, or None where it is None or not ok."""
    if res is None or not bool(np.asarray(res.ok)):
        return None
    g, e = cs.init_errors(np.asarray(res.imu.R, np.float64),
                          np.asarray(res.imu.v, np.float64), R_gt, v_gt)
    return [g, e, float(np.asarray(res.scale))]


def dynamic_draws(n_draws, overrides):
    """The dynamic initializer's accuracy under other RANSAC draws, on the
    attempt windows of chip_smoke.py's dynamic stream (DYN_SIM with
    `overrides`; the JAX writer's bytes of DYN_FRAMES frames, of which the
    first 16 are run: attempts on frames 10 and 15). The JAX package's host loop (float32, CPU) tracks the frames;
    on each window both packages draw n_draws times (JAX: PRNGKey(DRAW_SEED
    + i); the port, float32 on the CPU: a generator seeded DRAW_SEED + i),
    and each init is held against the ground truth as chip_smoke.py holds
    the card's (gravity direction, speed)."""
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    import orcvio_tpu.init.dynamic as jdyn
    import orcvio_tpu.run_vio as jrun
    from orcvio_tpu.dataio.synthetic import SimConfig as JSim
    from scipy.spatial.transform import Rotation

    import chip_smoke as cs
    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.config.yaml_io import load_reference_yaml
    from orcvio_tpu_torch.filter.pipeline import FrameInput
    from orcvio_tpu_torch.init import dynamic as pdyn

    jdyn.dynamic_initialize = jax.jit(jdyn.dynamic_initialize,
                                      static_argnums=0)
    sim = {**cs.DYN_SIM, **overrides}
    tmp = tempfile.mkdtemp(prefix="orcvio_jax_draws_")
    windows, attempt = [], jdyn.flexible_dynamic_attempt

    def spy(cfg, window, R_b2c, t_c_b, key, *a, **kw):
        res = attempt(cfg, window, R_b2c, t_c_b, key, *a, **kw)
        windows.append((int(np.asarray(key).reshape(-1)[-1]),
                        (cfg, list(window), R_b2c, t_c_b), res))
        return res

    out = {"sim": sim, "draws": n_draws, "seed": cs.DRAW_SEED,
           "good": cs.DRAW_GOOD, "windows": []}
    try:
        d = os.path.join(tmp, "dynamic")
        jsim = JSim(n_frames=cs.DYN_FRAMES, **sim)
        jwriter.write_euroc_dataset(d, jsim)
        cfg_path = os.path.join(d, "config.yaml")
        jwriter.write_reference_config(cfg_path, jsim, output_dir=d + "/out/")
        jdyn.flexible_dynamic_attempt = spy
        try:
            jrun.main(["--euroc", d, "--config", cfg_path, "--out",
                       os.path.join(tmp, "traj.txt"), "--backend", "cpu",
                       "--max-frames", "16",
                       "--imu-slab", str(cs.BENCH_FILTER["imu_slab"])])
        finally:
            jdyn.flexible_dynamic_attempt = attempt
        seq = jeuroc.load_euroc(d)
        pcfg = load_reference_yaml(cfg_path)[0]
        pcfg = FilterConfig(**{**pcfg.__dict__,
                               "imu_slab": cs.BENCH_FILTER["imu_slab"]})
        for k, args, res in windows:
            R_gt = Rotation.from_quat(seq.gt_q[k]).as_matrix()
            v_gt = seq.gt_v[k]
            cfg, window, R_b2c, t_c_b = args
            pwin = [FrameInput(**{f: torch.as_tensor(np.asarray(getattr(w, f)))
                                  for f in FrameInput._fields})
                    for w in window]
            jd = [_init_errors(attempt(cfg, window, R_b2c, t_c_b,
                                       jax.random.PRNGKey(cs.DRAW_SEED + i)),
                               R_gt, v_gt, cs) for i in range(n_draws)]
            pd = [_init_errors(pdyn.flexible_dynamic_attempt(
                pcfg, pwin, np.asarray(R_b2c), np.asarray(t_c_b),
                generator=torch.Generator().manual_seed(cs.DRAW_SEED + i)),
                R_gt, v_gt, cs) for i in range(n_draws)]

            def n_good(draws):
                return sum(x is not None
                           and x[0] <= cs.DRAW_GOOD["gravity_deg"]
                           and x[1] <= cs.DRAW_GOOD["speed_err"]
                           for x in draws)

            out["windows"].append({
                "frame": k, "run": _init_errors(res, R_gt, v_gt, cs),
                "speed_gt": float(np.linalg.norm(v_gt)),
                "jax": jd, "port": pd, "jax_good": n_good(jd),
                "port_good": n_good(pd)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


if __name__ == "__main__":
    if "--jax-dynamic-draws" in sys.argv:
        # [--draws N] [--set key=value ...]: DYN_SIM overrides
        args = sys.argv[sys.argv.index("--jax-dynamic-draws") + 1:]
        n, over = 16, {}
        for a, b in zip(args[::2], args[1::2]):
            if a == "--draws":
                n = int(b)
            elif a == "--set":
                key, val = b.split("=")
                over[key] = float(val) if "." in val else int(val)
        torch.set_num_threads(4)
        print(json.dumps(dynamic_draws(n, over)))
        sys.exit(0)
    if "--jax-euroc-ate" not in sys.argv:
        sys.exit("usage: python tests/test_torch_euroc.py --jax-euroc-ate")
    print(json.dumps(jax_euroc_figures()))
