"""The frozen yardstick: the roofline count against hand counts, the
union of device intervals, the generator's determinism in the seed, the
reference's rotations and flags, and the check for JAX's modules."""
import json
import sys
import types

import numpy as np
import pytest
import torch

from vio_bench import generate, harness, peaks, trace
from vio_bench.reference import msckf
from vio_bench.rooflines import k4


def test_k4_count_at_the_filters_shape():
    # D = 172, q = 444 float64, H P given: P, K, HP read and P' written
    D, q = 172, 444
    P = torch.zeros(3, D, D, dtype=torch.float64)
    K = torch.zeros(3, D, q, dtype=torch.float64)
    HP = torch.zeros(3, q, D, dtype=torch.float64)
    nbytes, ops, dtype = k4.count([P, K, None, HP], [True] * 3 + [False],
                                  {}, 3)
    assert nbytes == 3 * 8 * (D * D + D * q + q * D + D * D)
    assert ops == 3 * 2 * D * D * q
    assert dtype == "float64"
    # in float64 the bytes bound it: 5.09 MB at 3.35 TB/s (1.52 us)
    # against 78.8 MFLOP at 67 TFLOP/s (1.18 us)
    assert peaks.least_seconds(nbytes, ops, dtype) == pytest.approx(
        nbytes / 3.35e12)
    assert nbytes / 3.35e12 > ops / 67e12
    # the Schmidt entry keeps [nb:, nb:]: its products are not counted
    _, ops_nb, _ = k4.count([P[0], K[0], None, HP[0], 100], [False] * 5, {}, 1)
    assert ops_nb == 2 * q * (D * D - (D - 100) ** 2)


def test_union_of_device_intervals():
    busy, merged = trace.union([(0, 10), (5, 20), (30, 40), (40, 41)])
    assert busy == pytest.approx(31e-9)
    assert merged == [[0, 20], [30, 41]]


CFG = {"camera": {"frame_hz": 20.0, "fov_limit": 1.2},
       "imu": {"imu_hz": 200.0, "gyro_noise": 0.004, "acc_noise": 0.08},
       "extrinsics": {"R_b2c": [[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]],
                      "t_c_b": [0.0, 0.0, 0.0]},
       "filter": {"imu_slab": 12}}
TRACKS = {"generator": "synthetic_tracks", "rows": 3, "frames": 4,
          "trajectory": {"n_landmarks": 50, "max_obs": 10, "radius": 3.0,
                         "omega": 0.6, "uv_noise": 0.002, "seed": 0}}


def test_generator_is_deterministic_in_the_seed():
    big = 2 ** 31 + 12345
    a = generate.make(CFG, TRACKS, big, "cpu")
    b = generate.make(CFG, TRACKS, big, "cpu")
    c = generate.make(CFG, TRACKS, 7, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["uvs"], c["uvs"])
    assert not torch.equal(a["gyro"], c["gyro"])
    # each row its own noise, one world
    assert not torch.equal(a["uvs"][0], a["uvs"][1])
    assert torch.equal(a["fids"][0], a["fids"][1])


@pytest.mark.parametrize("theta", [1e-3, 1.0, 3.0])
def test_reference_so3_series_meet_the_closed_forms(theta):
    w = theta * np.array([0.6, -0.48, 0.64])
    W = msckf.hat(w)
    s, c = np.sin(theta), np.cos(theta)
    closed = [np.eye(3) + s / theta * W + (1 - c) / theta**2 * W @ W,
              np.eye(3) + (1 - c) / theta**2 * W + (theta - s) / theta**3
              * W @ W,
              np.eye(3) / 2 + (theta - s) / theta**3 * W
              + (theta**2 / 2 + c - 1) / theta**4 * W @ W]
    tol = 1e-14 if theta > 0.1 else 1e-9  # the closed forms cancel
    for k, want in enumerate(closed):
        assert np.abs(msckf._series(w, k) - want).max() < tol
    R = msckf.exp(w)
    assert np.abs(R @ R.T - np.eye(3)).max() < 1e-14
    assert msckf.angle(R) == pytest.approx(theta, rel=1e-12)


def test_reference_refuses_flags_it_does_not_compute():
    cfg = json.loads((harness.HERE / "configs" / "msckf_orcvio.json")
                     .read_text())["filter"]
    msckf.check_flags(cfg)
    with pytest.raises(ValueError):
        msckf.check_flags(dict(cfg, if_zupt=True))
    with pytest.raises(ValueError):
        msckf.check_flags(dict(cfg, tri_translation_threshold=0.2))


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    for name in ("orcvio_tpu_torch", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "orcvio_tpu.vio",
                        types.ModuleType("orcvio_tpu.vio"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "orcvio_tpu"]


def test_nothing_of_the_yardstick_imports_the_port():
    import subprocess

    code = ("import sys\n"
            "import vio_bench.generate, vio_bench.trace, vio_bench.check, "
            "vio_bench.peaks, vio_bench.reference.msckf, "
            "vio_bench.rooflines.k4\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'orcvio_tpu_torch', 'orcvio_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
