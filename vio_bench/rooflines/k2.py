"""K2, Lucas-Kanade over one pyramid level (csrc/lk_level.cu, the level
route): its op entry and the work each call needs.

The benchmark wraps ``lk_level_src`` as ``orcvio_tpu_torch/frontend/klt.py``
binds it, the name the tracker's LK calls it by, so that under vmap one
range holds the batch's one launch. Counted at what every feature needs
whatever its data. Bytes: the taps it reads, the template's (P+3)^2 of the
first level and one (P+1)^2 block of the second (the least any search
visits), but no more than the two levels read once (the frames' levels,
which every row of a batch shares); each offset, aux row and output row
once. Operations: the template with its gradients and Hessian (6 a tap of
the (P+2)^2), one Gauss-Newton step (11 a tap of P^2) and the final
residual (3 a tap); steps beyond the first depend on the data and are not
counted.
"""
from __future__ import annotations

AUX_W, OUT_W = 16, 8  # ops/lk_pallas.py: aux and output row widths
ENTRY = ("orcvio_tpu_torch.frontend.klt", "lk_level_src")


def work(n: int, patch: int, levels: int, itemsize: int) -> tuple[int, int]:
    """(bytes, operations) of one level for n features at patch P, the two
    levels holding `levels` elements together."""
    P = patch
    taps = min(n * ((P + 3) ** 2 + (P + 1) ** 2), levels)
    return (itemsize * (taps + n * (AUX_W + OUT_W)) + 16 * n,
            n * (6 * (P + 2) ** 2 + 14 * P * P))


def count(args, batched, kwargs, rows: int):
    """(bytes, operations, dtype name) of one call lk_level_src(img0,
    off0, img1, off1, aux, iters, patch, ...) made for `rows` rows at
    once; aux with its rows first where batched."""
    img0, img1, aux = args[0], args[2], args[4]
    patch = args[6] if len(args) > 6 else kwargs["patch"]
    levels = sum(x.shape[-2] * x.shape[-1] for x in (img0, img1))
    return (*work(rows * aux.shape[-2], patch, levels, aux.element_size()),
            "float32")
