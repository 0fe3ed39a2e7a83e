"""PyTorch + CUDA port of orcvio_tpu, for one NVIDIA H100.

The package mirrors ``orcvio_tpu``'s subpackages and module names, so each
function has a counterpart at the same path. It imports neither JAX nor the
JAX package. Plain tensor code is PyTorch; every Pallas kernel on a ported
path is a CUDA C++ kernel under ``csrc/``, built on first use by
``ops/_build.py``.

Entry points take ``device=``. Without one they run on the card, and they
raise where there is no card: they never fall back to the CPU by themselves.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else cuda.

    Raises RuntimeError when no device was given and CUDA is unavailable."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "orcvio_tpu_torch runs on a CUDA device; none is available. "
            "Pass device='cpu' to run the plain PyTorch versions.")
    return torch.device("cuda")


def no_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    cuDNN defaults to TF32 (about three decimal digits), which would round
    pixels in any blur written as a convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
