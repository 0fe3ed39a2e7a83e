"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit), the yardstick of every roofline share. The
float64 rate is the FP64 tensor cores', so a share counts the same work
whatever implements it; float32 outside the tensor cores runs at 67
TFLOP/s too."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float64": 67e12, "float32": 67e12}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the bytes at the
    memory's rate and the operations at dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOP_PER_S[dtype])
