"""Filter state: dataclasses of tensors with fixed capacities and masks.

Counterpart of ``orcvio_tpu/filter/state.py`` (reference: StateServer,
orcvio.h:128-172). The flax pytrees become dataclasses with ``replace``;
every capacity, mask and covariance layout is the JAX package's, so padded
rows match one for one. The state has no weights, hence no ``nn.Module``.

Error-state layout (orcvio.cpp:201-222):
  [0:3] theta, [3:6] v, [6:9] p, [9:12] bg, [12:15] ba,
  [15:21] extrinsic, [21] td, [22 + 6k : 28 + 6k] clone k,
  then the EKF feature blocks, the 24 IMU-intrinsic states (calib_imu, at
  ``FilterConfig.intrinsic_base``) and the Schmidt nuisance clones (last).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..config.core import FilterConfig
from ..tree import Tree

LEG = 22
THETA = slice(0, 3)
VEL = slice(3, 6)
POS = slice(6, 9)
BG = slice(9, 12)
BA = slice(12, 15)


def take(x, i):
    """x[i] for a 0-d index tensor, without the host read that indexing with
    a 0-d tensor makes."""
    return x.index_select(0, i.reshape(1).long())[0]


def _eye3(dtype, device):
    return torch.eye(3, dtype=dtype, device=device)


@dataclasses.dataclass
class ImuState(Tree):
    """IMU mean state. Orientation stored as R: body->world (imu_state.h:53)."""

    R: torch.Tensor  # (3, 3)
    v: torch.Tensor  # (3,)
    p: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)

    @classmethod
    def identity(cls, dtype, device):
        z = torch.zeros(3, dtype=dtype, device=device)
        return cls(R=_eye3(dtype, device), v=z, p=z, bg=z, ba=z)


@dataclasses.dataclass
class CloneStates(Tree):
    """Sliding-window IMU pose clones in a ring buffer (slot != age);
    ``order`` is the insertion counter, -1 = invalid."""

    R: torch.Tensor  # (SW, 3, 3) body->world at clone time
    p: torch.Tensor  # (SW, 3)
    p_fej: torch.Tensor  # (SW, 3) first-estimate position
    t: torch.Tensor  # (SW,)
    order: torch.Tensor  # (SW,) int32
    valid: torch.Tensor  # (SW,) bool

    @classmethod
    def empty(cls, sw: int, dtype, device):
        return cls(
            R=_eye3(dtype, device).repeat(sw, 1, 1),
            p=torch.zeros((sw, 3), dtype=dtype, device=device),
            p_fej=torch.zeros((sw, 3), dtype=dtype, device=device),
            t=torch.zeros((sw,), dtype=dtype, device=device),
            order=torch.full((sw,), -1, dtype=torch.int32, device=device),
            valid=torch.zeros((sw,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass
class FeatureTable(Tree):
    """Per-feature observations aligned to clone slots: uv[f, c] is the
    normalized (u, v) of feature row f in clone slot c."""

    uv: torch.Tensor  # (F, SW, 2)
    uv_vel: torch.Tensor  # (F, SW, 2)
    uv_valid: torch.Tensor  # (F, SW) bool
    fid: torch.Tensor  # (F,) int32 external track id, -1 = free row
    active: torch.Tensor  # (F,) bool, tracked this frame
    in_state: torch.Tensor  # (F,) bool, lives in the covariance
    state_slot: torch.Tensor  # (F,) int32 EKF block slot, -1 = none
    anchor_slot: torch.Tensor  # (F,) int32 clone slot of the anchor camera
    idp: torch.Tensor  # (F, 3) inverse depth (alpha, beta, rho) in anchor cam

    @classmethod
    def empty(cls, f_cap: int, sw: int, dtype, device):
        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=device)

        return cls(
            uv=full((f_cap, sw, 2), 0, dtype),
            uv_vel=full((f_cap, sw, 2), 0, dtype),
            uv_valid=full((f_cap, sw), False, torch.bool),
            fid=full((f_cap,), -1, torch.int32),
            active=full((f_cap,), False, torch.bool),
            in_state=full((f_cap,), False, torch.bool),
            state_slot=full((f_cap,), -1, torch.int32),
            anchor_slot=full((f_cap,), -1, torch.int32),
            idp=full((f_cap, 3), 0, dtype),
        )


@dataclasses.dataclass
class NuiClones(Tree):
    """Schmidt nuisance clones (nui_imu_states, orcvio.h:167-170): pruned
    clones that still anchor EKF features, at most nuisance_cap (one
    masked row when the cap is 0)."""

    R: torch.Tensor  # (N, 3, 3)
    p: torch.Tensor  # (N, 3)
    t: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,)

    @classmethod
    def empty(cls, n: int, dtype, device):
        m = max(n, 1)
        return cls(
            R=_eye3(dtype, device).repeat(m, 1, 1),
            p=torch.zeros((m, 3), dtype=dtype, device=device),
            t=torch.zeros((m,), dtype=dtype, device=device),
            valid=torch.zeros((m,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass
class FilterState(Tree):
    """The complete filter state (StateServer equivalent)."""

    t: torch.Tensor  # scalar time of the imu state
    imu: ImuState
    imu_old: ImuState  # before the last propagation step
    imu_fej_now: ImuState
    imu_fej_old: ImuState
    td: torch.Tensor  # scalar
    R_b2c: torch.Tensor  # (3, 3) imu->camera rotation
    t_c_b: torch.Tensor  # (3,) camera position in the imu frame
    clones: CloneStates
    features: FeatureTable
    P: torch.Tensor  # (D, D) error-state covariance
    next_order: torch.Tensor  # int32 clone insertion counter
    initialized: torch.Tensor  # bool
    last_gyro: torch.Tensor  # (3,) last raw gyro
    last_acc: torch.Tensor  # (3,) last raw acc
    nui: NuiClones
    Tg: torch.Tensor  # (3, 3) gyro scale/misalignment (calib_imu)
    As: torch.Tensor  # (3, 3) gyro g-sensitivity
    Ma: torch.Tensor  # (3, 3) acc scale/misalignment, lower triangular

    @classmethod
    def create(cls, cfg: FilterConfig, dtype=torch.float32, device=None):
        device = resolve_device(device)
        imu = ImuState.identity(dtype, device)
        P = torch.diag(torch.as_tensor(cfg.initial_cov_diag(), dtype=dtype,
                                       device=device))

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(
            t=zeros(()),
            imu=imu, imu_old=imu, imu_fej_now=imu, imu_fej_old=imu,
            td=torch.full((), cfg.td, dtype=dtype, device=device),
            R_b2c=_eye3(dtype, device),
            t_c_b=zeros(3),
            clones=CloneStates.empty(cfg.sw_size, dtype, device),
            features=FeatureTable.empty(cfg.max_features, cfg.sw_size, dtype,
                                        device),
            P=P,
            next_order=zeros((), torch.int32),
            initialized=zeros((), torch.bool),
            last_gyro=zeros(3),
            last_acc=zeros(3),
            nui=NuiClones.empty(cfg.nuisance_cap, dtype, device),
            Tg=_eye3(dtype, device),
            As=zeros((3, 3)),
            Ma=_eye3(dtype, device),
        )


def set_rows(base, rows, values, *rest):
    """base[rows, *rest] = values, where rows == len(base) is dropped: JAX's
    ``.at[...].set(..., mode="drop")`` with the spill index len(base). The
    write goes through a spill row, so no mask has to be read back."""
    ext = torch.cat([base, base[:1]])
    return ext.index_put((rows.long(), *rest), values)[:-1]


def put(x, i, v):
    """x with x[i] = v for a 0-d index tensor i (JAX's x.at[i].set(v))."""
    return x.index_copy(0, i.reshape(1).long(), v.unsqueeze(0).to(x.dtype))


def set_block(P, idx, blk):
    """P[idx[:, None], idx[None, :]] = blk, dropping every row and column
    whose index is len(P) (a spill row and a spill column)."""
    D = P.shape[0]
    ext = torch.nn.functional.pad(P, (0, 1, 0, 1))
    i = idx.long()
    return ext.index_put((i[:, None], i[None, :]), blk)[:D, :D]


# IMU-intrinsic error-vector packing, order [T1 T2 T3 | A1 A2 A3 | M1 M2]
# (orcvio.cpp:176-194, updateImuMx :4373): X1 the entries below the
# diagonal (1,0), (2,0), (2,1); X2 the diagonal; X3 the entries above it
# (0,1), (0,2), (1,2). Ma has no upper part: its upper triangle is never
# moved.
_LO = ((1, 0), (2, 0), (2, 1))
_DI = ((0, 0), (1, 1), (2, 2))
_UP = ((0, 1), (0, 2), (1, 2))
_FULL = _LO + _DI + _UP
_TRI = _LO + _DI


def imu_intrinsics_to_vec(Tg, As, Ma):
    """(24,) [Tg's 9 | As's 9 | Ma's lower triangle 6] in the reference's
    order."""
    return torch.stack([M[i, j] for M, idx in ((Tg, _FULL), (As, _FULL),
                                               (Ma, _TRI)) for i, j in idx])


def _as_matrix(d, idx):
    """The 3x3 matrix with d[k] at idx[k] and zeros elsewhere, built from
    views of d (no index tensor, so nothing is copied to the device)."""
    at = {ij: k for k, ij in enumerate(idx)}
    zero = torch.zeros_like(d[0])
    return torch.stack([torch.stack([d[at[i, j]] if (i, j) in at else zero
                                     for j in range(3)]) for i in range(3)])


def apply_imu_intrinsics_delta(Tg, As, Ma, d24):
    """(Tg, As, Ma) moved by the 24-vector d24, entry by entry
    (orcvio.cpp:4523-4533); Ma's upper triangle stays as it is."""
    return (Tg + _as_matrix(d24[0:9], _FULL),
            As + _as_matrix(d24[9:18], _FULL),
            Ma + _as_matrix(d24[18:24], _TRI))
