"""Kernel K4, the covariance update sym(P - K H P): the port's plain version
against the JAX package's Pallas kernel (interpret mode) and its XLA
reference. The CUDA kernel is held against the plain version on a card in
``test_torch_cuda.py``.

Tolerances: float32 against the Pallas kernel, atol 2e-4, as the JAX
package's own test holds its kernel to its reference; float64 against the
reference, 1e-12 (both compute the same sums in another order). The
output is exactly symmetric.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.ops.cov_update import cov_update_pallas, cov_update_reference
from orcvio_tpu_torch.ops.cov_update import cov_update, cov_update_plain

torch.set_num_threads(1)

# the JAX package's shapes (tests/test_pallas_ops.py) and the bench's
# stacked update: D = 172 error states, q = 444 rows
SHAPES = [(142, 96), (190, 384), (128, 128), (50, 20), (172, 444)]


def _inputs(D, q, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D))
    P = (A @ A.T / D).astype(dtype)
    K = (rng.normal(size=(D, q)) * 0.1).astype(dtype)
    H = (rng.normal(size=(q, D)) * 0.1).astype(dtype)
    return P, K, H


@pytest.mark.parametrize("D,q", SHAPES)
def test_plain_matches_pallas_f32(D, q):
    P, K, H = _inputs(D, q, D + q, np.float32)
    ref = np.asarray(cov_update_pallas(jnp.asarray(P), jnp.asarray(K),
                                       jnp.asarray(H), interpret=True))
    out = cov_update_plain(*map(torch.as_tensor, (P, K, H))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(out, out.T)


@pytest.mark.parametrize("D,q", SHAPES)
def test_plain_matches_reference_f64(D, q):
    P, K, H = _inputs(D, q, 7 * D + q, np.float64)
    ref = np.asarray(cov_update_reference(jnp.asarray(P), jnp.asarray(K),
                                          jnp.asarray(H)))
    tP, tK, tH = map(torch.as_tensor, (P, K, H))
    out = cov_update(tP, tK, tH).numpy()  # CPU tensors: the plain version
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(out, out.T)
    with_hp = cov_update(tP, tK, tH, HP=tH @ tP).numpy()
    np.testing.assert_array_equal(with_hp, out)
