"""ctypes bindings for the native EuRoC loader (``native/euroc_loader.cpp``).

Counterpart of ``orcvio_tpu/dataio/native.py``: the same interface as the
Python reader in ``euroc.py`` plus threaded PNG decoding (libpng). The
library is built from the repository's source on first use with ``g++``
into ``orcvio_tpu_torch/_build/``, keyed on a hash of the source and the
flags, and never into ``native/``, where the JAX package keeps its own.
``build_native`` raises where g++ or libpng's headers are missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "euroc_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O2", "-shared", "-fPIC")
LIBS = ("-lpng", "-lpthread")


def build_native(force: bool = False) -> str:
    """Compile the loader unless built; returns the library's path.

    Raises RuntimeError with the compiler's output where it cannot be
    built (no g++, no libpng headers)."""
    if not SOURCE.exists():
        raise RuntimeError(f"native loader source missing: {SOURCE}")
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join(FLAGS + LIBS).encode())
    so = BUILD_DIR / f"libeuroc_loader-{key.hexdigest()[:16]}.so"
    if so.exists() and not force:
        return str(so)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native loader: g++ not found")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode:
        first = next((ln for ln in proc.stderr.splitlines() if "error" in ln),
                     "")
        raise RuntimeError(f"native loader build failed (g++ exit "
                           f"{proc.returncode}): {first}\n{proc.stderr}")
    os.replace(tmp, so)
    return str(so)


_dbl = ctypes.POINTER(ctypes.c_double)


def _ptr(a: np.ndarray, ctype=ctypes.c_double):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeEurocLoader:
    """Threaded native EuRoC reader with the euroc.py interface and images."""

    def __init__(self, root: str, prefetch_threads: int = 3,
                 prefetch_ahead: int = 8):
        lib = ctypes.CDLL(build_native())
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        sigs = {
            "el_open": (vp, [ctypes.c_char_p]),
            "el_num_frames": (ci, [vp]),
            "el_num_imu": (ci, [vp]),
            "el_num_gt": (ci, [vp]),
            "el_frame_times": (None, [vp, _dbl]),
            "el_copy_imu": (None, [vp, _dbl, _dbl, _dbl]),
            "el_copy_gt": (None, [vp, _dbl, _dbl, _dbl]),
            "el_bin_imu": (None, [vp, ci, cd, cd, _dbl, _dbl, _dbl,
                                  ctypes.POINTER(ctypes.c_uint8)]),
            "el_image_size": (ci, [vp, ctypes.POINTER(ci),
                                   ctypes.POINTER(ci)]),
            "el_start_prefetch": (None, [vp, ci, ci]),
            "el_get_image": (ci, [vp, ci, ctypes.POINTER(ctypes.c_float), ci]),
            "el_close": (None, [vp]),
        }
        for name, (res, args) in sigs.items():
            getattr(lib, name).restype = res
            getattr(lib, name).argtypes = args
        self._lib = lib
        self._h = lib.el_open(root.encode())
        if not self._h:
            raise RuntimeError(f"el_open failed for {root}")
        self.n_frames = lib.el_num_frames(self._h)
        self.n_imu = lib.el_num_imu(self._h)
        self.n_gt = lib.el_num_gt(self._h)

        self.cam_t = np.zeros(self.n_frames)
        lib.el_frame_times(self._h, _ptr(self.cam_t))
        self.imu_t = np.zeros(self.n_imu)
        self.gyro = np.zeros((self.n_imu, 3))
        self.acc = np.zeros((self.n_imu, 3))
        lib.el_copy_imu(self._h, _ptr(self.imu_t), _ptr(self.gyro),
                        _ptr(self.acc))
        if self.n_gt:
            self.gt_t = np.zeros(self.n_gt)
            self.gt_p = np.zeros((self.n_gt, 3))
            self.gt_q = np.zeros((self.n_gt, 4))
            lib.el_copy_gt(self._h, _ptr(self.gt_t), _ptr(self.gt_p),
                           _ptr(self.gt_q))
        else:
            self.gt_t = self.gt_p = self.gt_q = None

        w, h = ctypes.c_int(), ctypes.c_int()
        if self.n_frames and lib.el_image_size(self._h, ctypes.byref(w),
                                               ctypes.byref(h)) == 0:
            self.width, self.height = w.value, h.value
        else:
            self.width = self.height = 0
        if prefetch_threads > 0 and self.n_frames:
            lib.el_start_prefetch(self._h, prefetch_threads, prefetch_ahead)

    def bin_imu(self, slab: int, td: float = 0.0,
                imu_rate_hint: float = 200.0):
        """(imu_t, gyro, acc, mask) slabs, as euroc.bin_imu_per_frame."""
        K = self.n_frames
        out_t = np.zeros((K, slab))
        out_g = np.zeros((K, slab, 3))
        out_a = np.zeros((K, slab, 3))
        out_m = np.zeros((K, slab), np.uint8)
        self._lib.el_bin_imu(self._h, slab, td, imu_rate_hint, _ptr(out_t),
                             _ptr(out_g), _ptr(out_a),
                             _ptr(out_m, ctypes.c_uint8))
        return out_t, out_g, out_a, out_m.astype(bool)

    def get_image(self, k: int) -> np.ndarray:
        """Frame k as (H, W) float32 in [0, 255]."""
        buf = np.zeros(self.width * self.height, np.float32)
        n = self._lib.el_get_image(self._h, k, _ptr(buf, ctypes.c_float),
                                   buf.size)
        if n < 0:
            raise RuntimeError(f"el_get_image({k}) -> {n}")
        return buf[:n].reshape(self.height, self.width)

    def close(self):
        if self._h:
            self._lib.el_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
