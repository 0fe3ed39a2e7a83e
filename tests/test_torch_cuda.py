"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and nvcc, is marked ``cuda`` and skips
where there is none. The file imports neither JAX nor the JAX package, so
it runs on a machine with PyTorch alone (``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

K4 (``csrc/cov_update.cu``): float32 within the float32 rounding bound of
two length-q sums, scaled to the inputs (1e-4 at these shapes); float64
to 1e-12. The output is exactly symmetric, whatever the shape.
"""
import numpy as np
import pytest
import torch

from orcvio_tpu_torch.ops.cov_update import cov_update, cov_update_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(D, q, seed, dtype, device):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D))
    return tuple(torch.as_tensor(x, dtype=dtype, device=device) for x in (
        A @ A.T / D, rng.normal(size=(D, q)) * 0.1,
        rng.normal(size=(q, D)) * 0.1))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("D,q", [(172, 444), (172, 384), (172, 9), (50, 20),
                                 (17, 1)])
def test_cov_update_matches_plain(card, dtype, atol, D, q):
    P, K, H = _inputs(D, q, D + q, dtype, card)
    n = cov_update.launches
    out = cov_update(P, K, H)
    torch.cuda.synchronize()
    assert cov_update.launches == n + 1
    assert torch.equal(out, out.T)
    assert float((out - cov_update_plain(P, K, H)).abs().max()) < atol


def test_cov_update_rejects_what_it_cannot_take(card):
    P, K, H = _inputs(20, 8, 0, torch.float32, card)
    with pytest.raises(ValueError):
        cov_update(P, K.double(), H)
    with pytest.raises(TypeError):
        cov_update(P.half(), K.half(), H.half())
