"""Sequence parallelism: one trajectory replayed as K time blocks at once.

Counterpart of ``orcvio_tpu/parallel/temporal.py``, function for function.
The reference's filter is a serial per-frame loop (app/orcvioMain.cpp:
106-198), so its wall clock grows with the trajectory. Here a T-frame
trajectory is cut into K contiguous blocks that are replayed together,
then stitched by an associative gauge composition:

 * Within a block the filter is the unchanged ``filter_step``. The K
   blocks run as one batch through ``parallel/replay.py``'s vmap of the
   single-stream step (K4 serves every block's update through its batched
   entry), cut into one chunk per device of a ``mesh``.
 * VIO's global gauge (yaw about gravity and the world translation) is
   unobservable, so a block's output moves equivariantly under a gauge
   move of its start state. Blocks compose exactly in the 4-dim gauge
   group; the observable part of a boundary state (roll, pitch, velocity,
   biases, the window) is handed across one boundary per outer iteration
   and converges in a few.
 * The stitch hands the full end state of block b-1 to block b, so at
   ``n_iters = n_blocks`` the result is the serial replay's. The JAX
   package's is bit-exact there; the port's batched products sum in
   another order than its single-stream ones, which moves p by some 1e-10
   m over 120 frames in float64 (ROADMAP section 3 item 20).

MSCKF configurations only (``ekf_feature_cap == 0``, ``nuisance_cap ==
0``). At ``n_iters < n_blocks`` the end covariance misses the earlier
blocks' unobservable-gauge random walk; the measured per-block correction
(``gauge_cov_correction``) adds it back. The iteration-0 block starts come
from per-block IMU preintegration composed across blocks, so no serial
sweep of the trajectory ever runs.

Host reads: the blocks' frames read nothing back. The stitch reads
nothing; the covariance correction runs ``torch.linalg.pinv`` (an SVD)
and ``eigh``, whose CUDA versions check their solver's status on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import no_tf32
from ..config.core import FilterConfig
from ..filter.pipeline import FrameInput
from ..filter.state import LEG, FilterState
from ..math import so3
from ..tree import tree_index, tree_map, tree_stack
from .replay import sharded_replay_fn


def _mv(M, v):
    """(..., i, j) @ (..., j) -> (..., i)."""
    return torch.einsum("...ij,...j->...i", M, v)


# --------------------------------------------------------------------------
# the gauge group: g = (psi, dp), a yaw about world z and a translation
# --------------------------------------------------------------------------

class Gauge(NamedTuple):
    psi: torch.Tensor  # (...) yaw
    dp: torch.Tensor  # (..., 3) world translation


def gauge_identity(dtype=torch.float32, device=None) -> Gauge:
    return Gauge(torch.zeros((), dtype=dtype, device=device),
                 torch.zeros(3, dtype=dtype, device=device))


def _rz(psi):
    """(...) yaw -> (..., 3, 3) rotation about z."""
    c, s = torch.cos(psi), torch.sin(psi)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def gauge_compose(g1: Gauge, g2: Gauge) -> Gauge:
    """(g1 o g2) x = g1 (g2 x)."""
    return Gauge(g1.psi + g2.psi, g1.dp + _mv(_rz(g1.psi), g2.dp))


def _is_left(cfg: FilterConfig) -> bool:
    # as increment_state (augment.py): LARVIO forces the left perturbation
    return bool(cfg.use_larvio or cfg.use_left_perturbation)


def gauge_diff(x_new: FilterState, x_old: FilterState) -> Gauge:
    """The gauge move g with x_new ~ g x_old (exact in yaw and position).

    Yaw is the vertical component of the relative rotation's log; the rest
    of a roll or pitch difference is no gauge freedom and is left to the
    outer iteration."""
    dR = x_new.imu.R @ x_old.imu.R.T
    psi = so3.log(dR)[2]
    dp = x_new.imu.p - _mv(_rz(psi), x_old.imu.p)
    return Gauge(psi, dp)


def gauge_T(cfg: FilterConfig, psi, D: int, dtype):
    """(D, D) error-state change of coordinates under a gauge rotation.

    World-frame error 3-vectors (v, p, clone p, and theta and clone theta
    under the left perturbation) rotate by Rz(psi); body-frame ones
    (biases, extrinsics, td, IMU intrinsics, right-perturbation theta)
    stay. Laid out as filter/state.py's error state (LEG = 22)."""
    R = _rz(psi).to(dtype)
    dev = R.device
    I3 = torch.eye(3, dtype=dtype, device=dev)
    th = R if _is_left(cfg) else I3
    sw = cfg.sw_size
    blocks = [th, R, R, torch.eye(LEG - 9, dtype=dtype, device=dev)]
    blocks += [th, R] * sw
    rest = D - LEG - 6 * sw
    if rest:
        blocks.append(torch.eye(rest, dtype=dtype, device=dev))
    return torch.block_diag(*blocks)


def gauge_apply(cfg: FilterConfig, state: FilterState, g: Gauge) -> FilterState:
    """The full filter state moved by a global gauge move (exact).

    Means: R <- Rz R, p <- Rz p + dp, v <- Rz v (the IMU, its FEJ and old
    copies, the valid clones and nuisance clones). Covariance: P <- T P T^T.
    Camera-relative quantities (features, biases, extrinsics, td) stay."""
    R = _rz(g.psi).to(state.P.dtype)

    def rot_imu(s):
        return s.replace(R=R @ s.R, v=_mv(R, s.v), p=_mv(R, s.p) + g.dp)

    cl = state.clones
    v3 = cl.valid[:, None]
    clones = cl.replace(
        R=torch.where(cl.valid[:, None, None],
                      torch.einsum("ij,sjk->sik", R, cl.R), cl.R),
        p=torch.where(v3, torch.einsum("ij,sj->si", R, cl.p) + g.dp, cl.p),
        p_fej=torch.where(v3, torch.einsum("ij,sj->si", R, cl.p_fej) + g.dp,
                          cl.p_fej))
    D = state.P.shape[0]
    T = gauge_T(cfg, g.psi, D, state.P.dtype)
    P = T @ state.P @ T.T
    nui = state.nui
    if cfg.nuisance_cap:
        nui = nui.replace(
            R=torch.where(nui.valid[:, None, None],
                          torch.einsum("ij,sjk->sik", R, nui.R), nui.R),
            p=torch.where(nui.valid[:, None],
                          torch.einsum("ij,sj->si", R, nui.p) + g.dp, nui.p))
    return state.replace(
        imu=rot_imu(state.imu), imu_old=rot_imu(state.imu_old),
        imu_fej_now=rot_imu(state.imu_fej_now),
        imu_fej_old=rot_imu(state.imu_fej_old),
        clones=clones, nui=nui, P=0.5 * (P + P.T))


# --------------------------------------------------------------------------
# the gauge subspace's covariance: basis, extraction, inflation
# --------------------------------------------------------------------------

def gauge_basis(cfg: FilterConfig, state: FilterState, anchor=None):
    """B (D, 4): the error-state directions of the gauge group at `state`.

    Column 0 is the yaw generator, columns 1-3 the world translation.
    `anchor`: the point the yaw turns about (None: the world origin).
    Anchored at the IMU's position, a block's gauge increments add under
    the lever-arm transport (``_transport_gauge_cov``). The theta rows
    hold e_z under the left perturbation (world-frame errors), R^T e_z
    under the right; the v rows z x v in both. Invalid clones' rows are
    zero."""
    P = state.P
    D, dtype, dev = P.shape[0], P.dtype, P.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    z = eye[2]
    a = torch.zeros(3, dtype=dtype, device=dev) if anchor is None else anchor
    left = _is_left(cfg)

    def cross_z(v):
        return torch.linalg.cross(z.expand(v.shape), v, dim=-1)

    def rows(col0, trans):
        """(..., 3, 4) rows: col0 in column 0, trans in columns 1-3."""
        return torch.cat([col0[..., None], trans], dim=-1)

    zero3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    th = z if left else state.imu.R.T @ z
    leg = torch.cat([rows(th, zero3), rows(cross_z(state.imu.v), zero3),
                     rows(cross_z(state.imu.p - a), eye),
                     torch.zeros((LEG - 9, 4), dtype=dtype, device=dev)])
    cl = state.clones
    sw = cfg.sw_size
    ok = cl.valid[:, None]
    thk = z.expand(sw, 3) if left else _mv(cl.R.transpose(-1, -2), z)
    blk = torch.cat([
        rows(torch.where(ok, thk, 0.0), zero3.expand(sw, 3, 3)),
        rows(torch.where(ok, cross_z(cl.p - a), 0.0),
             torch.where(ok[..., None], eye, 0.0))], dim=1)
    return torch.cat([leg, blk.reshape(6 * sw, 4),
                      torch.zeros((D - LEG - 6 * sw, 4), dtype=dtype,
                                  device=dev)])


def gauge_covariance(cfg: FilterConfig, state: FilterState, anchor=None):
    """(4, 4) covariance of the gauge coordinates: B+ P B+^T.

    The pseudo-inverse's cutoff is the JAX package's (jnp.linalg.pinv's
    default rtol, 10 max(m, n) eps; torch's default is a tenth of it)."""
    B = gauge_basis(cfg, state, anchor)
    rtol = 10.0 * max(B.shape) * torch.finfo(B.dtype).eps
    Bp = torch.linalg.pinv(B, rtol=rtol)  # (4, D)
    S = Bp @ state.P @ Bp.T
    return 0.5 * (S + S.T)


def inflate_gauge(cfg: FilterConfig, state: FilterState, Q4,
                  anchor=None) -> FilterState:
    """P <- P + B Q4 B^T: gauge-subspace process covariance added."""
    B = gauge_basis(cfg, state, anchor)
    P = state.P + B @ Q4 @ B.T
    return state.replace(P=0.5 * (P + P.T))


def _transport_gauge_cov(Q4, dpsi, lever):
    """A gauge covariance carried across a yaw move and an anchor change.

    A yaw error about anchor a_j, expressed about anchor a_K, picks up the
    translation psi z x (a_K - a_j): T = [[1, 0], [z x lever, Rz]]."""
    R = _rz(dpsi).to(Q4.dtype)
    eye = torch.eye(4, dtype=Q4.dtype, device=Q4.device)
    z = eye[3, 1:]
    top = eye[:1]
    low = torch.cat([torch.linalg.cross(z, lever, dim=-1)[:, None], R], dim=1)
    T = torch.cat([top, low])
    return T @ Q4 @ T.T


# --------------------------------------------------------------------------
# iteration-0 block starts: per-block IMU preintegration, composed
# --------------------------------------------------------------------------

class _Preint(NamedTuple):
    dR: torch.Tensor  # (..., 3, 3)
    dv: torch.Tensor  # (..., 3)
    dp: torch.Tensor  # (..., 3)
    dt: torch.Tensor  # (...)


def _preint_compose(a: _Preint, b: _Preint) -> _Preint:
    """Gravity-free body-frame composition (associative)."""
    return _Preint(dR=a.dR @ b.dR, dv=a.dv + _mv(a.dR, b.dv),
                   dp=a.dp + a.dv * b.dt[..., None] + _mv(a.dR, b.dp),
                   dt=a.dt + b.dt)


def _preint_identity(shape, dtype, device) -> _Preint:
    return _Preint(torch.eye(3, dtype=dtype, device=device).expand(
        *shape, 3, 3), torch.zeros((*shape, 3), dtype=dtype, device=device),
        torch.zeros((*shape, 3), dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device))


def _block_preintegrate(cfg: FilterConfig, state0: FilterState, t, gyro, acc,
                        mask, t_start):
    """Forward-Euler preintegration of a block's IMU stream, bias-corrected
    with state0's biases (it only seeds the outer iteration).

    t (..., N), gyro and acc (..., N, 3), mask (..., N), t_start (...): a
    leading axis of blocks runs them all at once. A masked sample adds
    nothing; dt is clipped to [0, 0.05] s."""
    bg, ba = state0.imu.bg, state0.imu.ba
    pre = _preint_identity(t.shape[:-1], state0.P.dtype, state0.P.device)
    prev_t = t_start
    for j in range(t.shape[-1]):
        ti, m = t[..., j], mask[..., j]
        dt = torch.where(m, torch.clamp(ti - prev_t, 0.0, 0.05), 0.0)
        dt3 = dt[..., None]
        w = gyro[..., j, :] - bg
        a = acc[..., j, :] - ba
        pre = _Preint(dR=pre.dR @ so3.exp(w * dt3),
                      dv=pre.dv + _mv(pre.dR, a * dt3),
                      dp=pre.dp + pre.dv * dt3
                      + 0.5 * _mv(pre.dR, a * dt3 * dt3),
                      dt=pre.dt + dt)
        prev_t = torch.where(m, ti, prev_t)
    return pre


def initial_starts(cfg: FilterConfig, state0: FilterState, frames: FrameInput,
                   n_blocks: int) -> FilterState:
    """Iteration-0 block start states, stacked (K, ...): every block's IMU
    preintegrated at once, composed across blocks, gravity applied once.
    Block 0 starts at state0."""
    K = n_blocks
    Tb = frames.t.shape[0] // K
    dtype, dev = state0.P.dtype, state0.P.device
    g_w = torch.eye(3, dtype=dtype, device=dev)[2] * -cfg.gravity

    # block start times: state0's for block 0, the prior block's last frame
    t_starts = torch.cat([state0.t[None], frames.t[Tb - 1:(K - 1) * Tb:Tb]])

    def flat(x):
        return x[:K * Tb].reshape(K, Tb * x.shape[1], *x.shape[2:])

    pres = _block_preintegrate(cfg, state0, flat(frames.imu_t),
                               flat(frames.imu_gyro), flat(frames.imu_acc),
                               flat(frames.imu_mask), t_starts)

    # prefix[b] = D_0 o ... o D_{b-1} (the identity for b = 0)
    prefixes = [_preint_identity((), dtype, dev)]
    for b in range(K - 1):
        prefixes.append(_preint_compose(prefixes[-1], tree_index(pres, b)))
    pre = _Preint(*(torch.stack(x) for x in zip(*prefixes)))

    R0, v0, p0 = state0.imu.R, state0.imu.v, state0.imu.p
    dt = pre.dt[:, None]
    R = R0 @ pre.dR
    v = v0 + _mv(R0, pre.dv) + g_w * dt
    p = p0 + v0 * dt + _mv(R0, pre.dp) + 0.5 * g_w * dt**2
    starts = tree_stack([state0] * K)
    imu = starts.imu.replace(R=R, v=v, p=p)
    return starts.replace(imu=imu, imu_old=imu, imu_fej_now=imu,
                          imu_fej_old=imu, t=t_starts.to(state0.t.dtype))


# --------------------------------------------------------------------------
# the block-parallel replay
# --------------------------------------------------------------------------

def _block_frames(frames: FrameInput, n_blocks: int) -> FrameInput:
    """(T, ...) -> (K, T // K, ...); trailing frames past K (T // K) are
    dropped."""
    K = n_blocks
    Tb = frames.t.shape[0] // K
    return tree_map(lambda x: x[:K * Tb].reshape(K, Tb, *x.shape[1:]), frames)


def make_block_replay(cfg: FilterConfig, chi2_table, mesh=None):
    """replay(starts, blocks) -> (ends, outs): the K blocks' replays as one
    batch (starts (K, ...), blocks FrameInput of (K, Tb, ...)), through
    ``parallel/replay.py:sharded_replay_fn`` over `mesh` (a list of
    devices; default the starts' device): each device a contiguous chunk
    of blocks, frame after frame, the results on mesh[0]."""

    def replay(starts, blocks):
        devices = mesh or [starts.P.device]
        return sharded_replay_fn(cfg, devices)(starts, blocks, chi2_table)

    return replay


def _stitch(cfg: FilterConfig, state0: FilterState, ends, old_starts):
    """The next iteration's block starts from this one's ends (O(K) small
    ops).

    The best estimate at boundary b is block b-1's end (the full state:
    covariance, window, feature table), gauge-moved by the correction that
    block b-1's own start received this iteration. Block 0 always starts
    at state0, so block b is the serial replay's once iteration >= b.
    Returns (new starts, deltas), stacked over K."""
    K = ends.t.shape[0]
    dtype, dev = state0.P.dtype, state0.P.device
    new_starts = [state0]
    deltas = [gauge_identity(dtype, dev)]
    for b in range(1, K):
        end_prev = tree_index(ends, b - 1)
        m = gauge_diff(end_prev, tree_index(old_starts, b))
        new_starts.append(gauge_apply(cfg, end_prev, deltas[b - 1]))
        deltas.append(gauge_compose(deltas[b - 1], m))
    return tree_stack(new_starts), Gauge(*(torch.stack(x)
                                           for x in zip(*deltas)))


def _check_msckf(cfg: FilterConfig) -> None:
    if cfg.ekf_feature_cap or cfg.nuisance_cap:
        # By design: the stitch needs every boundary coordinate to be gauge
        # equivariant or locally observable. EKF-SLAM feature blocks and
        # Schmidt nuisance clones are neither: their P rows are keyed to
        # table rows whose identity is block-local, so the handed-over
        # covariance refers to states the next block cannot re-associate,
        # and the gauge composition has no action on them.
        raise ValueError(
            "sequence-parallel mode requires an MSCKF configuration "
            "(ekf_feature_cap=0, nuisance_cap=0): EKF-SLAM/Schmidt keep "
            "per-feature covariance rows whose identity is block-local, so "
            "they can be neither gauge-composed nor re-estimated across a "
            "block boundary")


def seq_parallel_replay(cfg: FilterConfig, state0: FilterState,
                        frames: FrameInput, chi2_table, n_blocks: int,
                        n_iters: int = 3, mesh=None,
                        gauge_cov_correction: bool = True):
    """Block-parallel replay of one trajectory.

    Returns (end state, outs): outs holds "p", "R" and "v" (gauge-corrected,
    comparable with the serial replay), "t", "n_update_features" and
    "dx_norm", each (K (T // K), ...). The tensors' device is state0's;
    `mesh` (a list of devices) spreads the blocks over several.

    gauge_cov_correction: at n_iters < n_blocks the end covariance has
    crossed only the last n_iters blocks and misses the gauge random walk
    of the earlier ones (the observable subspace contracts to the serial
    answer, the gauge subspace cannot). Each block's gauge-covariance
    increment is measured from the last iteration's runs, and the missing
    blocks' sum is added back into P (nothing at n_iters >= n_blocks)."""
    _check_msckf(cfg)
    no_tf32()
    K = n_blocks
    replay = make_block_replay(cfg, chi2_table, mesh)
    fb = _block_frames(frames, K)

    starts = initial_starts(cfg, state0, frames, K)
    ends = outs = prev_starts = deltas = None
    for _ in range(n_iters):
        prev_starts = starts
        ends, outs = replay(starts, fb)
        starts, deltas = _stitch(cfg, state0, ends, prev_starts)

    # each block's trajectory and the sequence's end state (block K-1's
    # end) corrected by its block's start delta
    R = _rz(deltas.psi).to(outs.p.dtype)  # (K, 3, 3)
    flat = {"p": torch.einsum("kij,ktj->kti", R, outs.p) + deltas.dp[:, None],
            "R": torch.einsum("kij,ktjl->ktil", R, outs.R),
            "v": torch.einsum("kij,ktj->kti", R, outs.v)}
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in flat.items()}
    end = gauge_apply(cfg, tree_index(ends, K - 1),
                      Gauge(deltas.psi[K - 1], deltas.dp[K - 1]))

    if gauge_cov_correction and n_iters < K:
        # per-block increments in position-anchored gauge coordinates (both
        # ends of block j about its end position), PSD-clipped (an update
        # can shrink the projected covariance for a while), each missing
        # block's carried to the final anchor
        d_sig = torch.stack([
            gauge_covariance(cfg, e, e.imu.p)
            - gauge_covariance(cfg, s, e.imu.p)
            for e, s in ((tree_index(ends, j), tree_index(prev_starts, j))
                         for j in range(K))])
        w, V = torch.linalg.eigh(d_sig)
        d_sig = torch.einsum("kij,kj,klj->kil", V, torch.clamp(w, min=0.0), V)
        a_end = end.imu.p
        psi_end = deltas.psi[K - 1]
        q = sum(_transport_gauge_cov(d_sig[j], psi_end - deltas.psi[j],
                                     a_end - ends.imu.p[j])
                for j in range(K - n_iters))
        end = inflate_gauge(cfg, end, q, a_end)
    extras = {k: getattr(outs, k).reshape((-1,) + getattr(outs, k).shape[2:])
              for k in ("t", "n_update_features", "dx_norm")}
    return end, {**extras, **flat}
