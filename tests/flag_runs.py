"""Runs of the filter's flag variants in both packages, shared by
tests/test_torch_flags_*.py.

Each variant (``orcvio_tpu_torch/eval/bench_setup.py:VARIANTS``) is the
fixture's configuration of tests/test_torch_filter.py (``generate(SIM)``,
8 clones, 48 feature rows, 6 EKF features, 8 update features, the bench
flags) with the variant's overrides. From one initialized state (the
fixture's pose, the variant's initial covariance) both packages run T = 60
frames of filter_step in float64 on the CPU (100 under Schmidt), with
pixel velocities added to the frames where td is estimated and the IMU
slab cut to 12 samples under calib_imu: the JAX package as one
jitted lax.scan, the port frame by frame. Spies count the calls of the
functions that make up each variant's branch: in the JAX package they run
when the step is traced (so a count >= 1 says the branch is compiled into
the step), in the port on every frame.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orcvio_tpu.filter.hybrid as jhyb
import orcvio_tpu.filter.propagation as jprop
import orcvio_tpu.filter.update as jupd
import orcvio_tpu.math.linalg as jlinalg
import orcvio_tpu_torch.filter.propagation as pprop
import orcvio_tpu_torch.filter.update as pupd
import orcvio_tpu_torch.math.linalg as plinalg
from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter import pipeline as jpipe
from orcvio_tpu.filter.state import FilterState as JaxState
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.filter import pipeline as ppipe
from orcvio_tpu_torch.eval.bench_setup import VARIANTS
from tests.test_torch_filter import CFG, port_frame
from tests.test_torch_filter_ops import to_jax as jax_state_like
from tests.test_torch_filter import sim_frames as _sim_frames

T = 60
# The Schmidt variants run the fixture's whole 100 frames: their nuisance
# slots fill from frame 37 on, and the first is retired on frame 65.
T_SCHMIDT = 100
TOL = 1e-8
# Variants whose runs amplify rounding more than the fixture's base does,
# measured on the JAX package alone: multiplying every observation by
# (1 + 1e-15 n), n standard normal, moves JAX's own p by up to 7.5e-9 m
# over the 60 frames under OrcVIO propagation (1.1e-8 m for a 1e-13 m
# shift of the start), and by 9.8e-8 m under the information form (its LU
# of M = I + P H^T H / sigma^2, sigma = 0.004). The port is held to five
# and ten times those.
TOLS = {"orcvio_prop": 5e-8, "orcvio_euler": 5e-8,
        "update_information": 1e-6}

# (package module, function) pairs spied per variant: (JAX, port)
SPIES = {
    "orcvio_prop": [(jprop, pprop, "phi_closed_form_left")],
    "orcvio_right": [(jprop, pprop, "phi_closed_form_right")],
    "orcvio_euler": [(jprop, pprop, "phi_euler")],
    "update_qr": [(jlinalg, plinalg, "qr_compress")],
    "update_chol": [(jlinalg, plinalg, "chol_compress")],
    "update_information": [(jupd, pupd, "information_update")],
    "calib_imu": [(jprop, pprop, "_bias_intrinsic_sensitivity")],
}
# the Schmidt functions: the port's pipeline calls its own imported names
_SCHMIDT = [(jhyb, ppipe, "schmidt_demote"), (jhyb, ppipe, "retire_nuisance")]
SPIES.update(schmidt=_SCHMIDT, schmidt_ref=_SCHMIDT,
             calib_schmidt=_SCHMIDT + SPIES["calib_imu"])


sim_frames = functools.lru_cache(maxsize=1)(_sim_frames)

# the flags of the JAX package's FilterConfig() defaults (OrcVIO
# propagation, left perturbation, Euler Phi, no ZUPT, pure MSCKF), as a
# variant of the fixture
JAX_DEFAULTS = {k: getattr(JaxConfig(), k) for k in (
    "use_larvio", "use_left_perturbation", "use_closed_form_cov_prop",
    "if_fej", "estimate_extrinsic", "estimate_td", "if_zupt",
    "feature_idp_dim", "ekf_feature_cap", "update_form", "joseph_form")}


def with_pixel_velocities(frames):
    """The frames with each observation's velocity: its displacement from
    the same track's observation in the frame before, over the frame
    period (the fixture's are zero, and td is observed through them)."""
    fids, uvs, mask, ts = (np.asarray(frames[i]) for i in (5, 6, 8, 0))
    vel = np.zeros_like(uvs)
    for k in range(1, len(ts)):
        prev = {int(f): uvs[k - 1, i] for i, f in enumerate(fids[k - 1])
                if mask[k - 1, i]}
        for i, f in enumerate(fids[k]):
            if mask[k, i] and int(f) in prev:
                vel[k, i] = (uvs[k, i] - prev[int(f)]) / (ts[k] - ts[k - 1])
    return frames._replace(uv_vels=vel)


# The IMU slab of the calib_imu variants' frames: every fixture frame fills
# its first 10 of 24 slots, and a calib_imu step runs its slab sample by
# sample (the JAX package unrolls it, one jacfwd a sample, in the step it
# compiles), so these frames keep 12: the 10 and two masked samples, which
# are exact no-ops in both packages. It halves the JAX compile.
CALIB_SLAB = 12


def variant_frames(name: str):
    frames = sim_frames()[0]
    cfg = variant_cfg(name)
    if cfg.get("estimate_td"):
        frames = with_pixel_velocities(frames)
    if cfg.get("calib_imu"):
        assert not np.asarray(frames.imu_mask)[:, CALIB_SLAB:].any()
        frames = frames._replace(**{k: getattr(frames, k)[:, :CALIB_SLAB]
                                    for k in ("imu_t", "imu_gyro", "imu_acc",
                                              "imu_mask")})
    return frames


# runs beside the variants: the chol form without ZUPT, whose first
# update is a visual one
EXTRA = {"jax_defaults": JAX_DEFAULTS,
         "update_chol_no_zupt": {**VARIANTS["update_chol"], "if_zupt": False}}


def variant_cfg(name: str) -> dict:
    return {**CFG, **EXTRA.get(name, VARIANTS.get(name, {}))}


def initial_state(jcfg: JaxConfig):
    """The fixture's initialized state in the variant's layout."""
    _, st0 = sim_frames()
    st = JaxState.create(jcfg, jnp.float64)
    return st.replace(imu=st0.imu, imu_fej_now=st0.imu_fej_now,
                      imu_old=st0.imu_old, R_b2c=st0.R_b2c, t_c_b=st0.t_c_b,
                      initialized=st0.initialized)


def frame_events(in_state, anchor, nui_valid):
    """Per frame: promotions (rows entering the state), re-anchorings (rows
    staying in the state with another anchor), Schmidt demotions
    (nuisance slots taken) and retirements (nuisance slots freed). Frame
    0 has none."""
    in_state, anchor, nui = map(np.asarray, (in_state, anchor, nui_valid))
    stay = in_state[1:] & in_state[:-1]
    counts = ((in_state[1:] & ~in_state[:-1]).sum(axis=1),
              (stay & (anchor[1:] != anchor[:-1])).sum(axis=1),
              (nui[1:] & ~nui[:-1]).sum(axis=1),
              (~nui[1:] & nui[:-1]).sum(axis=1))
    return dict(zip(EVENTS, (np.concatenate([[0], c]) for c in counts)))


EVENTS = ("promoted", "reanchored", "demoted", "retired")


class _Counter:
    """Wraps module.fn, counting its calls."""

    def __init__(self, mp, module, name):
        self.n, fn = 0, getattr(module, name)

        def spy(*a, **kw):
            self.n += 1
            return fn(*a, **kw)

        mp.setattr(module, name, spy)


def n_frames(name: str) -> int:
    return T_SCHMIDT if variant_cfg(name).get("use_schmidt") else T


def _jax_lowered(name: str):
    """The JAX package's jitted lax.scan of n_frames(name) frames of
    variant `name`,
    lowered (traced, with the variant's spies counting), its inputs and
    the spies' counts."""
    frames = variant_frames(name)
    jcfg = JaxConfig(**variant_cfg(name))
    st0 = initial_state(jcfg)
    mp = pytest.MonkeyPatch()
    try:
        jspies = {fn: _Counter(mp, jm, fn) for jm, _, fn in SPIES.get(name, [])}
        chi2 = jpipe.build_chi2_table(jcfg, jnp.float64)

        def step(s, f):
            s, out = jpipe.filter_step(jcfg, s, f, chi2)
            return s, (out, s.features.in_state, s.features.anchor_slot,
                       s.nui.valid)

        fr = jax.tree.map(lambda x: jnp.asarray(x[:n_frames(name)]), frames)
        lowered = jax.jit(lambda s, f: jax.lax.scan(step, s, f)).lower(st0, fr)
    finally:
        mp.undo()
    return lowered, (st0, fr), {k: c.n for k, c in jspies.items()}


_COMPILED = {}


def compile_jax(names):
    """Trace the JAX runs of `names` one after another, then compile them
    in parallel threads (XLA's compile releases the GIL): their compiles
    take most of a run's time. run() takes them from here."""
    todo = [n for n in names if n not in _COMPILED]
    lowered = [_jax_lowered(n) for n in todo]
    with ThreadPoolExecutor(max(len(todo), 1)) as ex:
        compiled = list(ex.map(lambda lo: lo[0].compile(), lowered))
    for n, lo, c in zip(todo, lowered, compiled):
        _COMPILED[n] = (c, *lo[1:])


@functools.lru_cache(maxsize=None)
def run(name: str):
    """Both packages' runs of variant `name`: a dict per package of
    "out" (FrameOutput as numpy), "final" (the last state as numpy),
    "spies" ({function: calls}) and the per-frame EVENTS; the port's also
    "cov_update" (K4 wrapper calls)."""
    compile_jax([name])
    compiled, (st0, fr), jspies = _COMPILED[name]
    js, (jout, *jev) = compiled(st0, fr)
    return {"jax": dict(out=jax.tree.map(np.asarray, jout),
                        final=state_to_numpy(js), spies=jspies,
                        **frame_events(*jev)),
            "port": port_run(name)}


@functools.lru_cache(maxsize=None)
def port_run(name: str):
    """The port's run of variant `name` alone (run()'s "port" entry)."""
    frames = variant_frames(name)
    pcfg = FilterConfig(**variant_cfg(name))
    pchi2 = ppipe.build_chi2_table(pcfg, torch.float64, device="cpu")
    ps = filter_state_from_numpy(
        state_to_numpy(initial_state(JaxConfig(**variant_cfg(name)))),
        torch.float64, "cpu")
    outs, pev = [], []
    mp = pytest.MonkeyPatch()
    try:
        pspies = {fn: _Counter(mp, pm, fn) for _, pm, fn in SPIES.get(name, [])}
        k4 = _Counter(mp, pupd, "cov_update")
        for k in range(n_frames(name)):
            ps, out = ppipe.filter_step(pcfg, ps, port_frame(frames, k), pchi2)
            outs.append(out)
            pev.append((ps.features.in_state.numpy(),
                        ps.features.anchor_slot.numpy(), ps.nui.valid.numpy()))
    finally:
        mp.undo()
    return dict(
        out=ppipe.FrameOutput(*(torch.stack(x).numpy() for x in zip(*outs))),
        final=state_to_numpy(ps), spies={k: c.n for k, c in pspies.items()},
        cov_update=k4.n, **frame_events(*map(np.stack, zip(*pev))))


def check_pose(name: str, field: str):
    """p, R or v of every frame within the variant's tolerance; NaN where
    and only where the JAX package's is NaN."""
    r = run(name)
    j = getattr(r["jax"]["out"], field).reshape(n_frames(name), -1)
    p = getattr(r["port"]["out"], field).reshape(n_frames(name), -1)
    np.testing.assert_array_equal(np.isnan(p), np.isnan(j))
    err = np.nan_to_num(np.abs(j - p)).max(axis=1)
    tol = TOLS.get(name, TOL)
    assert err.max() < tol, (name, field, int(err.argmax()), float(err.max()))


def check_decisions(name: str):
    """Identical update counts, ZUPT flags, promotions, re-anchorings,
    demotions and retirements on every frame."""
    r = run(name)
    for key in ("n_update_features", "zupt"):
        np.testing.assert_array_equal(getattr(r["port"]["out"], key),
                                      getattr(r["jax"]["out"], key),
                                      err_msg=f"{name} {key}")
    for key in EVENTS:
        np.testing.assert_array_equal(r["port"][key], r["jax"][key],
                                      err_msg=f"{name} {key}")
