"""K1, the window gather (csrc/window_gather.cu): its op entry and the work
each call needs.

The benchmark wraps ``gather_windows`` as ``orcvio_tpu_torch/frontend/
klt.py`` binds it, the name the tracker's ORB stage calls it by
(``extract_patches``), so that under vmap one range holds the batch's one
launch. Counted as a copy: each window written once, C N rows lanes
elements, and the padded level they are cut from read once (the frame's
level, which every row of a batch shares); no operations.
"""
from __future__ import annotations

ENTRY = ("orcvio_tpu_torch.frontend.klt", "gather_windows")


def work(windows: int, level: int, rows: int, lanes: int,
         itemsize: int) -> tuple[int, int]:
    """(bytes, operations) of `windows` windows of rows x lanes cut from a
    level of `level` elements."""
    return itemsize * (windows * rows * lanes + level), 0


def count(args, batched, kwargs, rows: int):
    """(bytes, operations, dtype name) of one call
    gather_windows(ai, centers, t0, wd, rows, lanes) made for `rows` rows
    at once; centers with its rows first where batched."""
    ai, centers = args[0], args[1]
    win_rows = args[4] if len(args) > 4 else kwargs["rows"]
    lanes = args[5] if len(args) > 5 else kwargs["lanes"]
    C, Hp, Wp = ai.padded.shape[-3:]
    return (*work(rows * C * centers.shape[-2], C * Hp * Wp, win_rows, lanes,
                  ai.padded.element_size()), "float32")
