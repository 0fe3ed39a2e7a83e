"""The bench configuration the card scripts run: ``chip_smoke.py`` and
``scripts/flag_matrix.py``.

TRACKER is the front end ``bench.py:155-163`` builds; BENCH_SIM the bench
sequence of ``scripts/make_bench_seq.py:31-36`` (3 s static, then flight
at 4 m over a textured ground plane), which the EuRoC writer renders
(``dataio/euroc_writer.py:make_stream``); BENCH_FILTER the filter flags of
the bench's ``config.yaml``; VARIANTS the filter's flag variants, each as
overrides of BENCH_FILTER.
"""
from __future__ import annotations

import subprocess

TRACKER = dict(height=480, width=752, pyramid_levels=3, capacity=200,
               patch_size=15, klt_iters=10, grid_rows=8, grid_cols=10,
               per_cell=3, min_distance=20.0, detect_every=2, equalize=True,
               dist_model="radtan", dist_coeffs=(0.0, 0.0, 0.0, 0.0))
BENCH_SIM = dict(frame_hz=20.0, imu_hz=200.0, static_time=3.0,
                 ramp_time=1.5, height=4.0, radius=2.5, omega=0.5, seed=11,
                 gyro_noise=0.0024, acc_noise=0.028)
# the filter flags of the bench's config.yaml (euroc_writer.py:186-216, read
# by config/yaml_io.py:load_reference_yaml: D = 22 + 6*20 + 30 = 172) and
# the bench's IMU slab (bench.py:153)
BENCH_FILTER = dict(imu_slab=16, use_larvio=True, use_left_perturbation=False,
                    use_closed_form_cov_prop=True, if_zupt=True,
                    observation_noise=0.008, init_cov_extrin_rot=3.0462e-8,
                    init_cov_extrin_trans=9e-8, tri_translation_threshold=-1.0,
                    max_grid_features=1, feature_idp_dim=1, ekf_feature_cap=30)
# The bench flags are LARVIO propagation, right perturbation, closed-form
# covariance, ZUPT, 1-d inverse-depth EKF features and the "direct" update;
# each variant overrides some of them.
VARIANTS = {
    "orcvio_prop": dict(use_larvio=False, use_left_perturbation=True),
    "orcvio_right": dict(use_larvio=False, use_left_perturbation=False),
    "orcvio_euler": dict(use_larvio=False, use_left_perturbation=True,
                         use_closed_form_cov_prop=False),
    "left_perturb": dict(use_larvio=True, use_left_perturbation=True),
    "no_zupt": dict(if_zupt=False),
    "pure_msckf": dict(ekf_feature_cap=0),
    "hybrid_3d": dict(feature_idp_dim=3),
    "fej": dict(if_fej=True),
    "extrinsic_td": dict(estimate_extrinsic=True, estimate_td=True),
    "update_qr": dict(update_form="qr"),
    "update_chol": dict(update_form="chol"),
    "update_information": dict(update_form="information"),
    "joseph": dict(joseph_form=True),
    # the IMU intrinsics (24 states at intrinsic_base) and Schmidt nuisance
    # clones, with the cap the JAX package's own Schmidt run uses
    # (tests/test_hybrid_ekf.py)
    "calib_imu": dict(calib_imu=True),
    "schmidt": dict(use_schmidt=True, nuisance_cap=6),
    "schmidt_ref": dict(use_schmidt=True, nuisance_cap=6,
                        schmidt_reference_semantics=True),
    "calib_schmidt": dict(calib_imu=True, use_schmidt=True, nuisance_cap=6),
}


def bench_inputs(st, slab=None):
    """stage_sequence's inputs from a writer's in-memory stream
    (dataio/euroc_writer.py:make_stream): (images (n, H, W) uint8,
    frame_ts, imu_t, gyro, acc, mask), the IMU binned per frame as the
    readers bin it (slab: default the bench's)."""
    from ..dataio.euroc import EurocSequence, bin_imu_per_frame

    slab = BENCH_FILTER["imu_slab"] if slab is None else slab
    seq = EurocSequence(st.imu_ts, st.gyro, st.acc, st.frame_ts, [], None,
                        None, None, None)
    return (st.images, st.frame_ts, *bin_imu_per_frame(seq, slab))


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
