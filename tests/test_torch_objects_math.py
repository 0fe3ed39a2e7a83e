"""The object layer's SE(3)/SO(3) functions and residual blocks: the port
against the JAX package in float64 on the CPU, on seeded numpy inputs.

Every case within 1e-9 (the same arithmetic in another order: most agree
to 1e-14). The residuals and Jacobians run in every combination of the
perturbation flag (use_left) and the bbox form (use_new), on a window of
cameras around an object with some observations masked.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.math import se3 as jse3
from orcvio_tpu.math import so3 as jso3
from orcvio_tpu.objects import residuals as jres
from orcvio_tpu_torch.math import se3 as pse3
from orcvio_tpu_torch.math import so3 as pso3
from orcvio_tpu_torch.objects import residuals as pres

torch.set_num_threads(1)
TOL = 1e-9


def jj(fn, *static):
    """fn under jax.jit: one compile instead of one per eager primitive."""
    return jax.jit(fn, static_argnums=static)


jse3 = type("jit_se3", (), {n: staticmethod(jj(getattr(jse3, n))) for n in (
    "exp", "log", "circled_circ", "odot", "project_image", "pose_se3_to_se2",
    "displacement")})
jso3_ljinv = jj(jso3.left_jacobian_inv)
jres_feature_residual = jj(jres.feature_residual)
jres_feature_jacobians = jj(jres.feature_jacobians, 4)
jres_bbox_residual = jj(jres.bbox_residual, 5)
jres_bbox_jacobians = jj(jres.bbox_jacobians, 5, 6)


def close(p, j, tol=TOL):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=tol)


def twists(n, seed, scale=0.8):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)) * scale
    xi[0, 3:] = 0.0  # no rotation
    xi[1, 3:] = [1e-7, -2e-7, 5e-8]  # the small-angle branch
    xi[2, 3:] = [0.0, 0.0, np.pi - 1e-4]  # near pi
    return xi


def t(x):
    return torch.as_tensor(np.array(x))


def test_exp_log_and_left_jacobian_inv():
    xi = twists(16, 1)
    close(pse3.exp(t(xi)), jse3.exp(jnp.asarray(xi)))
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    close(pse3.log(t(T)), jse3.log(jnp.asarray(T)), 1e-8)
    close(pso3.left_jacobian_inv(t(xi[:, 3:])),
          jso3_ljinv(jnp.asarray(xi[:, 3:])))
    # log(exp(xi)) = xi away from pi
    close(pse3.log(pse3.exp(t(xi[3:]))), xi[3:], 1e-9)


def test_point_operators():
    rng = np.random.default_rng(2)
    ph = rng.normal(size=(5, 7, 4))
    close(pse3.circled_circ(t(ph)), jse3.circled_circ(jnp.asarray(ph)))
    close(pse3.odot(t(ph)), jse3.odot(jnp.asarray(ph)))
    close(pse3.project_image(t(ph)), jse3.project_image(jnp.asarray(ph)))
    T = np.asarray(jse3.exp(jnp.asarray(twists(9, 3))))
    close(pse3.pose_se3_to_se2(t(T)), jse3.pose_se3_to_se2(jnp.asarray(T)))
    T2 = np.asarray(jse3.exp(jnp.asarray(twists(9, 4))))
    for a, b in zip(pse3.displacement(t(T), t(T2)),
                    jse3.displacement(jnp.asarray(T), jnp.asarray(T2))):
        close(a, b)


def camera_window(T=6, K=12, seed=5):
    """Cameras on an arc looking at an object 6 m ahead; keypoints, a
    bbox per frame, masks with some observations off."""
    rng = np.random.default_rng(seed)
    wTo = np.asarray(jse3.exp(jnp.asarray([0.2, -0.1, 6.0, 0.05, -0.1, 0.7])))
    kps = rng.normal(size=(K, 3)) * 0.7
    shape = np.array([0.8, 2.0, 0.7])
    cTw = np.stack([np.asarray(jse3.exp(jnp.asarray(
        [0.3 * i, -0.1 * i, 0.05 * i, 0.02 * i, -0.03 * i, 0.01])))
        for i in range(T)])
    zs = rng.normal(size=(T, K, 2)) * 0.05
    zs_mask = rng.uniform(size=(T, K)) > 0.2
    c = rng.normal(size=(T, 2)) * 0.05
    zb = np.concatenate([c - 0.3, c + 0.25], axis=1)
    zb_mask = np.ones(T, bool)
    zb_mask[2] = False
    return wTo, kps, shape, cTw, zs, zs_mask, zb, zb_mask


def test_feature_block():
    wTo, kps, _, cTw, zs, zs_mask, _, _ = camera_window()
    close(pres.feature_residual(t(wTo), t(kps), t(cTw), t(zs), t(zs_mask)),
          jres_feature_residual(*map(jnp.asarray,
                                     (wTo, kps, cTw, zs, zs_mask))))
    for left in (True, False):
        for a, b in zip(
                pres.feature_jacobians(t(wTo), t(kps), t(cTw), t(zs_mask),
                                       left),
                jres_feature_jacobians(*map(jnp.asarray,
                                            (wTo, kps, cTw, zs_mask)), left)):
            close(a, b)


@pytest.mark.parametrize("use_left,use_new",
                         list(itertools.product((True, False), repeat=2)))
def test_bbox_block(use_left, use_new):
    wTo, _, shape, cTw, _, _, zb, zb_mask = camera_window()
    args = (wTo, shape, cTw, zb, zb_mask)
    close(pres.bbox_residual(*map(t, args), use_new),
          jres_bbox_residual(*map(jnp.asarray, args), use_new))
    for a, b in zip(pres.bbox_jacobians(*map(t, args), use_left, use_new),
                    jres_bbox_jacobians(*map(jnp.asarray, args), use_left,
                                        use_new)):
        close(a, b)


def test_regularizers_and_huber():
    rng = np.random.default_rng(6)
    kps, mean = rng.normal(size=(2, 12, 3))
    shape, smean = rng.normal(size=(2, 3))
    fm = np.array([True, False, True, True])
    close(pres.deform_residual(t(kps), t(mean), t(fm)),
          jres.deform_residual(jnp.asarray(kps), jnp.asarray(mean),
                               jnp.asarray(fm)))
    close(pres.shape_residual(t(shape), t(smean), t(fm)),
          jres.shape_residual(jnp.asarray(shape), jnp.asarray(smean),
                              jnp.asarray(fm)))
    x = rng.uniform(0, 4, size=50)
    for eps in (float("inf"), 0.7):
        close(pres.huber_apply(t(x), eps), jres.huber_apply(jnp.asarray(x), eps))
        close(pres.huber_jac_scale(t(x), eps),
              jres.huber_jac_scale(jnp.asarray(x), eps))
    close(pres.ellipse_from_shape(t(shape)),
          jres.ellipse_from_shape(jnp.asarray(shape)))
    zb = rng.normal(size=(5, 4))
    close(pres.bbox_lines(t(zb)), jres.bbox_lines(jnp.asarray(zb)))
