"""K4, the EKF covariance step sym(P - K (H P)) (csrc/cov_update.cu): its
op entry and the work each call needs.

The benchmark wraps the entry the filter calls, ``cov_update`` as
``orcvio_tpu_torch/filter/update.py`` binds it (the op entry
``ops/cov_update.py:cov_update``), in a profiler range, so whatever
implements the step is read against the same work. Counted as
chip_smoke.py:1019-1052 (``k4_times``) counts it: with H P given, each
input byte read once and the output written once, 2 D^2 + 2 D q elements;
2 q (D^2 - (D - nb)^2) operations, the block [nb:, nb:] needing none.
"""
from __future__ import annotations

ENTRY = ("orcvio_tpu_torch.filter.update", "cov_update")


def work(D: int, q: int, nb: int, itemsize: int) -> tuple[int, int]:
    """(bytes, operations) of one sym(P - K HP) at P (D, D), K (D, q),
    HP (q, D) given, the block [nb:, nb:] kept."""
    return (itemsize * (2 * D * D + 2 * D * q),
            2 * q * (D * D - (D - nb) ** 2))


def count(args, batched, kwargs, rows: int):
    """(bytes, operations, dtype name) of one call
    cov_update(P, K, H, HP=None, nb=None), made for `rows` rows at once
    (the call under vmap); args as the call's, each batched one with its
    rows first (`batched` says which). H P is counted given, as the
    filter passes it; where it is not, its product is counted too."""
    P, K = args[0], args[1]
    HP = args[3] if len(args) > 3 else kwargs.get("HP")
    nb = args[4] if len(args) > 4 else kwargs.get("nb")
    D, q = K.shape[-2], K.shape[-1]
    nb = D if nb is None else int(nb)
    nbytes, ops = work(D, q, nb, P.element_size())
    if HP is None:
        ops += 2 * q * D * D
    return rows * nbytes, rows * ops, str(P.dtype).replace("torch.", "")
