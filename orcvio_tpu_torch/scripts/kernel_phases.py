"""Where the time of kernels K2, K3 and K4 goes, phase by phase, on the card.

Builds copies of ``csrc/lk_level.cu`` (K2 and K3) and
``csrc/cov_update.cu`` (K4) with their ``clock64()`` phase stamps compiled
in (``-DKPHASES``, see ``csrc/phases.cuh``), runs each at the shapes its
path gives it and prints, as one JSON line, the median (and largest)
cycles each phase takes: per feature (one warp) for K2 and K3, per CTA for
K4 (cluster rank 0, which finishes last, and every rank), and the medians in microseconds at the SM clock
measured while the card was busy (a kernel that spins for 2e7 cycles
between two reads of the global nanosecond timer). Beside them the time
an empty kernel takes from one CUDA event to the next, the floor under
every kernel time chip_smoke.py reports, and the card's name, power limit
and largest SM clock.

    python -m orcvio_tpu_torch.scripts.kernel_phases

Needs a CUDA card and nvcc; the stamped builds go to
``orcvio_tpu_torch/_build/phases/``.
"""
from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys

import numpy as np
import torch

from ..frontend import klt
from ..ops import _build
from ..ops.window_gather import prepare_image
from .lk_times import level_pair

OUT = _build.BUILD_DIR / "phases"
V, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

K2_PHASES = ("aux and tile bounds", "template block copied, patch built",
             "gradients, Hessian, search block arrived",
             "Gauss-Newton steps", "residual, output", "total")
K3_PHASES = ("aux and tile bounds",
             "search block copies issued, template loaded",
             "search block arrived", "steps", "residual, output", "total")
K4_PHASES = ("q loop: copies and DMMA", "partials stored, cluster barrier",
             "partials of every rank added, P read, output stored",
             "closing cluster barrier", "total")

# An empty kernel (the launch floor), and one that spins for a number of
# SM cycles and reads the global nanosecond timer around them (the SM
# clock while the card is busy).
PROBES = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
__global__ void spin_kernel(long long cycles, long long* out) {
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  long long c1 = c0;
  while (c1 - c0 < cycles) c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = c1 - c0;
  out[1] = g1 - g0;
}
extern "C" int empty(void* s) {
  empty_kernel<<<1, 128, 0, (cudaStream_t)s>>>();
  return (int)cudaGetLastError();
}
extern "C" int spin(long long cycles, long long* out, void* s) {
  spin_kernel<<<1, 1, 0, (cudaStream_t)s>>>(cycles, out);
  return (int)cudaGetLastError();
}
"""


def _build_lib(name: str, source, defines=()) -> ctypes.CDLL:
    """Compile `source` (a csrc/ path, or CUDA text) with the kernels'
    flags and `defines` into OUT/lib<name>.so, and load it."""
    OUT.mkdir(parents=True, exist_ok=True)
    if isinstance(source, str):
        cu = OUT / f"{name}.cu"
        cu.write_text(source)
    else:
        cu = source
    so = OUT / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o",
                        str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"kernel_phases: nvcc failed on {cu.name}\n{r.stdout}"
                 f"{r.stderr}")
    return ctypes.CDLL(str(so))


@functools.cache
def _stamped(source: str) -> ctypes.CDLL:
    """csrc/<source>.cu built with its phase stamps (csrc/phases.cuh)."""
    return _build_lib(f"{source}_phases", _build.CSRC / f"{source}.cu",
                      ("-DKPHASES",))


def _event_ms(fn, reps: int = 50) -> float:
    """Median CUDA-event time of fn() with the stream kept busy, as
    chip_smoke.py times the kernels."""
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def _read(lib, rows: int) -> np.ndarray:
    buf = np.zeros((4096, 8), np.int64)
    lib.phases_read.argtypes = [V]
    lib.phases_read(buf.ctypes.data)
    return buf[:rows]


def _phases(names, stamps) -> dict:
    return {name: {"median": float(np.median(stamps[:, k])),
                   "max": int(stamps[:, k].max())}
            for k, name in enumerate(names)}


def _level_pair(dev, n: int):
    """lk_times.level_pair on the card: the two images padded as the
    tracker pads them, the positions and starts as float32."""
    img0, img1, xy, p1 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                          for a in level_pair(n))
    ai0, ai1 = (prepare_image(im[None], klt.MARGIN) for im in (img0, img1))
    return ai0, ai1, xy, p1


def k2_phases(dev, n: int = 200, eps: float = 0.01) -> dict:
    """One launch of K2's level route at level 0 of the bench front end,
    n features (lk_times.level_pair)."""
    ai0, ai1, xy, p1 = _level_pair(dev, n)
    s0 = klt.gather_level(ai0, xy, cut=False)
    s1 = klt.gather_level(ai1, p1, cut=False)
    c0, c1 = klt.gather_level(ai0, xy), klt.gather_level(ai1, p1)
    aux, _, _ = klt._level_aux(c0, c1, xy, p1, 15)
    lib = _stamped("lk_level")
    lib.lk_level_src.argtypes = [V, V, LL, LL, V, V, LL, LL, V, V, I, I, I,
                                 I, I, F, I, V]
    out = torch.empty((n, 8), device=dev)
    for _ in range(3):  # the last launch's stamps are read
        lib.lk_level_src(s0.level.data_ptr(), s0.offset.data_ptr(),
                         s0.level.shape[-1], s0.level.numel(),
                         s1.level.data_ptr(), s1.offset.data_ptr(),
                         s1.level.shape[-1], s1.level.numel(), aux.data_ptr(),
                         out.data_ptr(), n, 48, 256, 15, 10, eps,
                         dev.index or 0,
                         torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    stamps = _read(lib, n)
    return {"features": n, "eps": eps, "steps_mean": float(stamps[:, 6].mean()),
            "cycles": _phases(K2_PHASES, stamps[:, :6])}


def k3_phases(dev, n: int = 200, iters: int = 10) -> dict:
    """One launch of K3's level route as track_level makes it on the card,
    at level 0 of the bench front end, n features (lk_times.level_pair): the
    template from image 0's cut windows, `iters` steps over image 1 read in
    place."""
    ai0, ai1, xy, p1 = _level_pair(dev, n)
    tmpl = klt._template(klt.gather_level(ai0, xy), xy, 15)
    s1 = klt.gather_level(ai1, p1, cut=False)
    aux, _, _ = klt._iterate_aux(s1, tmpl, p1, 15)
    t, tgx, tgy = (x.contiguous() for x in tmpl[:3])
    lib = _stamped("lk_level")
    lib.lk_iterate_src.argtypes = [V, V, LL, LL, V, V, V, V, V, I, I, I, I,
                                   I, I, V]
    out = torch.empty((n, 8), device=dev)
    for _ in range(3):  # the last launch's stamps are read
        lib.lk_iterate_src(s1.level.data_ptr(), s1.offset.data_ptr(),
                           s1.level.shape[-1], s1.level.numel(),
                           t.data_ptr(), tgx.data_ptr(), tgy.data_ptr(),
                           aux.data_ptr(), out.data_ptr(), n, 48, 256, 15,
                           iters, dev.index or 0,
                           torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    stamps = _read(lib, n)
    return {"features": n, "steps": iters,
            "cycles": _phases(K3_PHASES, stamps[:, :6])}


def k4_phases(dev, D: int = 172, q: int = 444) -> dict:
    """One launch of K4 at the main path's stacked update, float32."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(D, D))
    P, K, HP = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (
        A @ A.T / D, rng.normal(size=(D, q)) * 0.1,
        rng.normal(size=(q, D)) * 0.1))
    lib = _stamped("cov_update")
    lib.cov_update_f32.argtypes = [V, V, V, V, I, I, I, I, V]
    out = torch.empty_like(P)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(3):
        lib.cov_update_f32(P.data_ptr(), K.data_ptr(), HP.data_ptr(),
                           out.data_ptr(), D, q, D, dev.index or 0, stream)
    torch.cuda.synchronize()
    nt = -(-D // 32)
    stamps = _read(lib, 4096)
    ran = stamps[:, 4] > 0
    stamps = stamps[ran]
    rank0 = stamps[stamps[:, 5] == 0]
    return {"shape": f"P ({D},{D}), K ({D},{q}), HP ({q},{D}) float32",
            "tile_pairs": nt * (nt + 1) // 2, "ctas": int(ran.sum()),
            "cycles_rank0": _phases(K4_PHASES, rank0[:, :5]),
            "cycles_every_rank": _phases(K4_PHASES, stamps[:, :5])}


def launch_floor_ms(probes) -> float:
    """CUDA-event time of an empty kernel, timed as the kernels are."""
    probes.empty.argtypes = [V]
    return _event_ms(lambda: probes.empty(
        torch.cuda.current_stream().cuda_stream))


def sm_mhz(probes, dev, cycles: int = 20_000_000) -> float:
    """The SM clock in MHz over `cycles` cycles of one busy thread, after a
    first spin that lets the clock rise."""
    probes.spin.argtypes = [LL, V, V]
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    for _ in range(2):
        probes.spin(cycles, out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    c, ns = out.tolist()
    return c / ns * 1e3


def _in_us(cycles: dict, mhz: float) -> dict:
    return {name: v["median"] / mhz for name, v in cycles.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    probes = _build_lib("probes", PROBES)
    floor = launch_floor_ms(probes)
    k2, k3, k4 = k2_phases(dev), k3_phases(dev), k4_phases(dev)
    mhz = sm_mhz(probes, dev)
    k2["us_median"] = _in_us(k2["cycles"], mhz)
    k3["us_median"] = _in_us(k3["cycles"], mhz)
    k4["us_median_rank0"] = _in_us(k4["cycles_rank0"], mhz)
    print(json.dumps({"kernel_phases": {
        "card": card, "sm_mhz_busy": mhz, "empty_kernel_ms": floor,
        "k2": k2, "k3": k3, "k4": k4}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
