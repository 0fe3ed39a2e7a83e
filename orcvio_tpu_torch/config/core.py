"""Typed configuration for the filter.

Counterpart of ``orcvio_tpu/config/core.py`` (reference: loadParameters,
orcvio.cpp:62-415): the same frozen dataclass, field for field, with the
same defaults. Fields select code paths and fix capacities.

The port runs the flags of the bench configuration
(``dataio/euroc_writer.py:write_reference_config``): LARVIO propagation
with the closed-form covariance, no left perturbation, ZUPT, 1-d
inverse-depth EKF features, the "direct" update. ``require_supported``
raises on the flag branches not ported yet (ROADMAP item 12) instead of
running something else.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    # --- static shape capacities ---
    sw_size: int = 20  # sliding-window clones (config/euroc.yaml: sw_size)
    max_features: int = 200  # feature-table capacity (>= max tracked per frame)
    max_update_features: int = 32  # max features stacked into one EKF update
    max_track_len: int = 6  # config: max_track_len
    min_track_len: int = 3  # minimum obs to use a feature
    imu_slab: int = 24  # max IMU samples per frame

    # --- algorithm switches (reference flags, config/euroc.yaml:1-135) ---
    use_larvio: bool = False  # use_larvio_flag: RK4 vs closed-form SE(3) propagation
    use_left_perturbation: bool = True  # use_left_perturbation_flag
    use_closed_form_cov_prop: bool = False  # use_closed_form_cov_prop_flag
    if_fej: bool = False  # if_FEJ
    estimate_extrinsic: bool = False  # estimate_extrin
    estimate_td: bool = False  # estimate_td
    if_zupt: bool = False  # if_ZUPT_valid
    use_schmidt: bool = False  # use_schmidt: keep pruned anchors as nuisance states
    nuisance_cap: int = 0  # static capacity of Schmidt nuisance clone blocks
    schmidt_reference_semantics: bool = False
    calib_imu: bool = False  # calib_imu_instrinsic: online Tg/As/Ma estimation
    prediction_only: bool = False  # prediction_only_flag: dead-reckon, no updates

    # --- noise densities (continuous), config keys noise_gyro etc. ---
    gyro_noise: float = 0.004
    acc_noise: float = 0.08
    gyro_bias_noise: float = 2e-6
    acc_bias_noise: float = 4e-5
    observation_noise: float = 0.035  # pixel-normalized meas sigma

    # --- initial covariance (config keys initial_covariance_*) ---
    init_cov_orientation: float = 4e-4
    init_cov_velocity: float = 0.25
    init_cov_position: float = 1.0
    init_cov_gyro_bias: float = 4e-4
    init_cov_acc_bias: float = 0.01
    init_cov_extrin_rot: float = 3e-4
    init_cov_extrin_trans: float = 2.5e-5
    init_cov_td: float = 4e-6
    init_cov_imu_intrinsic: float = 1e-4

    # --- misc ---
    gravity: float = 9.81  # GRAVITY_ACCELERATION (imu_state.h:20)
    td: float = 0.0
    chi2_confidence: float = 0.95
    huber_epsilon: float = 0.01  # triangulation LM huber
    zupt_max_feature_dis: float = 2e-3
    position_std_threshold: float = 8.0
    static_image_num: int = 20  # Static_Num (StaticInitializer.cpp)
    static_min_matches: int = 20  # min matched features per static frame
    static_outlier_ignore: int = 19  # top-k distances ignored as outliers

    # triangulation LM (feature.hpp:41-60 OptimizationConfig)
    tri_translation_threshold: float = 0.2
    tri_max_iters: int = 10
    tri_initial_damping: float = 1e-3

    # stacked-update form: "direct", "qr", "information" or "chol"
    update_form: str = "direct"
    joseph_form: bool = False
    object_residual_transport: bool = True
    object_observation_noise: float = 0.05

    # gating / pruning
    prune_last_chance: bool = True  # last-chance update on pruned clones
    max_grid_features: int = 0  # hybrid EKF-SLAM grid (0 = pure MSCKF)
    feature_idp_dim: int = 3  # 1 or 3 (1d/3d inverse-depth EKF features)
    ekf_feature_cap: int = 0  # EKF-SLAM feature state capacity (0 = pure MSCKF)

    @property
    def leg_dim(self) -> int:
        """Error-state dim of the IMU leg: theta v p bg ba + extrin(6) + td(1),
        22 whatever the estimate flags (orcvio.cpp:199)."""
        return 22

    @property
    def intrinsic_dim(self) -> int:
        """IMU-intrinsic error dims (calib_imu), placed after the EKF
        feature states."""
        return 24 if self.calib_imu else 0

    @property
    def intrinsic_base(self) -> int:
        return (self.leg_dim + 6 * self.sw_size
                + self.feature_idp_dim * self.ekf_feature_cap)

    @property
    def state_dim(self) -> int:
        return (self.leg_dim + 6 * self.sw_size
                + self.feature_idp_dim * self.ekf_feature_cap
                + self.intrinsic_dim
                + 6 * self.nuisance_cap)

    def initial_cov_diag(self) -> np.ndarray:
        d = np.zeros(self.state_dim)
        d[0:3] = self.init_cov_orientation
        d[3:6] = self.init_cov_velocity
        d[6:9] = self.init_cov_position
        d[9:12] = self.init_cov_gyro_bias
        d[12:15] = self.init_cov_acc_bias
        if self.estimate_extrinsic:
            d[15:18] = self.init_cov_extrin_rot
            d[18:21] = self.init_cov_extrin_trans
        if self.estimate_td:
            d[21] = self.init_cov_td
        if self.calib_imu:
            ib = self.intrinsic_base
            d[ib: ib + 24] = self.init_cov_imu_intrinsic
        return d

    def continuous_noise_cov(self) -> np.ndarray:
        """12x12 continuous-time noise covariance. Ref: orcvio.cpp:426-461."""
        q = np.zeros(12)
        q[0:3] = self.gyro_noise**2
        q[3:6] = self.acc_noise**2
        q[6:9] = self.gyro_bias_noise**2
        q[9:12] = self.acc_bias_noise**2
        return np.diag(q)


def require_supported(cfg: FilterConfig) -> None:
    """Raise NotImplementedError on a flag branch the port does not run yet.

    The port runs the bench flags; the other branches are ROADMAP item 12.
    """
    bad = [name for name, on in (
        ("use_larvio=False (the orcvio_prop Phi forms)", not cfg.use_larvio),
        ("use_left_perturbation", cfg.use_left_perturbation),
        ("if_fej", cfg.if_fej),
        ("calib_imu", cfg.calib_imu),
        ("estimate_extrinsic", cfg.estimate_extrinsic),
        ("estimate_td", cfg.estimate_td),
        ("use_schmidt / nuisance_cap", cfg.use_schmidt or cfg.nuisance_cap),
        ("joseph_form", cfg.joseph_form),
        (f"update_form={cfg.update_form!r}", cfg.update_form != "direct"),
        (f"feature_idp_dim={cfg.feature_idp_dim} with EKF features",
         cfg.ekf_feature_cap > 0 and cfg.feature_idp_dim != 1),
    ) if on]
    if bad:
        raise NotImplementedError(
            "orcvio_tpu_torch does not port these filter flags yet (ROADMAP "
            "item 12): " + ", ".join(bad))
