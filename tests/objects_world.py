"""The synthetic object world both packages run in the object tests.

``world(n_frames, ...)`` builds config A's world (OBJECTS.md,
``orcvio_tpu/eval/object_map_sim.py``) cut to n_frames, with the port's
numpy generator and detections (held to the JAX package's in
tests/test_torch_objects_eval.py), so that both packages see the same
numpy inputs: the VIO frames, every frame's detections, the ground truth,
and the JAX filter state started at the ground truth. ``min_frames`` and
``window`` are cut too, so that objects finalize within a short run (a
full window finalizes as a lost track does). The port's configuration is
``orcvio_tpu_torch/eval/object_map_sim.py:object_vio_config`` with the
same cuts.
"""
from __future__ import annotations


import jax.numpy as jnp
import numpy as np
import torch

from orcvio_tpu.config.core import FilterConfig as JaxFilterConfig
from orcvio_tpu.dataio.render_object import CAR_KEYPOINTS
from orcvio_tpu.dataio.synthetic import SimConfig
from orcvio_tpu.eval import object_map_sim as jsim
from orcvio_tpu.filter.state import FilterState as JaxFilterState
from orcvio_tpu.objects.lm import ObjectLMConfig as JaxLMConfig
from orcvio_tpu.objects.manager import ManagerConfig as JaxManagerConfig
from orcvio_tpu.objects.sort import SortConfig as JaxSortConfig
from orcvio_tpu.objects.vio_objects import ObjectVioConfig as JaxOVConfig
from orcvio_tpu_torch.dataio import synthetic as psyn
from orcvio_tpu_torch.eval import object_map_sim as psim
from orcvio_tpu_torch.filter.pipeline import FrameInput

R_B2C = np.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
T_C_B = np.asarray([0.05, 0.02, 0.0])


def jax_config(wc, use_object_update=True, min_frames=12, window=45,
               pose_history=256):
    """The JAX package's config A (run_object_mapping's), cut as given."""
    sim = SimConfig(n_frames=wc.n_frames, n_landmarks=400, max_obs=50,
                    uv_noise=wc.uv_noise, seed=wc.seed, radius=3.0, omega=0.5)
    fcfg = JaxFilterConfig(sw_size=10, max_features=80, max_track_len=6,
                           imu_slab=sim.imu_slab, observation_noise=0.004,
                           tri_translation_threshold=-1.0,
                           object_residual_transport=True)
    return sim, JaxOVConfig(
        filter=fcfg, lm=JaxLMConfig(iters=25),
        manager=JaxManagerConfig(capacity=wc.max_det + 4, window=window,
                                 n_kps=12, pose_history=pose_history,
                                 min_frames=min_frames,
                                 smooth_keypoints=True),
        sort=JaxSortConfig(capacity=wc.max_det + 4, max_age=3, min_hits=2,
                           iou_threshold=0.1),
        kps_mean=tuple(map(tuple, CAR_KEYPOINTS)),
        shape_mean=(0.80, 2.00, 0.70),
        use_object_residual_update=use_object_update, merge_duplicates=True,
        finalize_budget=1)


def port_config(wc, use_object_update=True, min_frames=12, window=45,
                pose_history=256):
    ocfg = psim.object_vio_config(wc, use_object_update)
    return ocfg._replace(manager=ocfg.manager._replace(
        min_frames=min_frames, window=window, pose_history=pose_history))


def jax_initial_state(fcfg, sim, dtype):
    """run_object_mapping's ground-truth start, its (R0, p0, v0) from the
    port's closed form (the JAX package's autodiff gives the same to
    float64 rounding)."""
    st = JaxFilterState.create(fcfg, dtype)
    R0, p0, v0 = psyn.initial_state_np(psyn.SimConfig(
        **{f: getattr(sim, f) for f in sim.__dataclass_fields__}))
    imu = st.imu.replace(R=jnp.asarray(R0, dtype), p=jnp.asarray(p0, dtype),
                         v=jnp.asarray(v0, dtype))
    d = np.asarray(fcfg.initial_cov_diag())
    d[:15] = 1e-6
    return st.replace(imu=imu, imu_fej_now=imu, imu_old=imu,
                      R_b2c=jnp.asarray(R_B2C, dtype),
                      t_c_b=jnp.asarray(T_C_B, dtype),
                      P=jnp.asarray(np.diag(d), dtype),
                      initialized=jnp.ones((), bool))


def world(n_frames, dtype=jnp.float64, **cuts):
    """Config A's world over n_frames: a dict of the JAX and port configs,
    the JAX initial filter state, the frames and detections (numpy), the
    ground truth and the objects."""
    wc = jsim.WorldConfig(n_frames=n_frames)
    sim, jcfg = jax_config(wc, **cuts)
    pwc = psim.WorldConfig(n_frames=n_frames)
    data = psyn.generate(psim.world_sim(pwc), R_b2c=R_B2C, t_c_b=T_C_B,
                         dtype=torch.float64, device="cpu")
    gt_R, gt_p = data.gt_R.numpy(), data.gt_p.numpy()
    objs = psim.make_world(pwc)
    dets = psim.detection_stream(pwc, objs, gt_R, gt_p,
                                 np.random.default_rng(wc.seed + 1))
    return dict(wc=wc, sim=sim, jcfg=jcfg, pcfg=port_config(pwc, **cuts),
                jstate=jax_initial_state(jcfg.filter, sim, dtype),
                frames=tuple(x.numpy() for x in data.frames), dets=dets,
                gt_p=gt_p, objs=objs)


def port_tensor(x, dtype=torch.float64):
    t = torch.as_tensor(np.array(x))
    return t.to(dtype) if t.is_floating_point() else t


def port_frame(frames, k, dtype=torch.float64):
    return FrameInput(*(port_tensor(x[k], dtype) for x in frames))
