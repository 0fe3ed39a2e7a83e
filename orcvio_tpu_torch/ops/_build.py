"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` into ``_build/lib<name>-<hash>.so``, keyed on a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew. Nothing is compiled when a module is
imported; ``build()`` starts one ``nvcc`` per source, all at once. The C
entry points return ``cudaGetLastError()`` after their launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("window_gather", "lk_level", "cov_update", "extract64",
           "triangulate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_SIGNATURES: dict[str, dict[str, list]] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def declare(source: str, fn: str, argtypes: list) -> None:
    """Record the ctypes signature of C entry `fn` in `source`.cu."""
    _SIGNATURES.setdefault(source, {})[fn] = argtypes


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(source: str) -> tuple[Path, Path]:
    src = CSRC / f"{source}.cu"
    key = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{source}-{key.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict:
    """Build the given sources in parallel where not built yet.

    Returns {source: {"seconds": s, "log": ptxas report}} for those built
    now. Raises RuntimeError with the compiler's output on failure."""
    nvcc = None
    started = {}
    t0 = time.perf_counter()
    for source in sources:
        src, so = _target(source)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[source] = (proc, tmp, so)
    report, failed = {}, []
    for source, (proc, tmp, so) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"--- {source}.cu (nvcc exit {proc.returncode}) ---"
                          f"\n{log}")
            continue
        os.replace(tmp, so)
        report[source] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def library(source: str) -> ctypes.CDLL:
    """The loaded library of `source`.cu, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(_target(source)[1]))
        for fn, argtypes in _SIGNATURES.get(source, {}).items():
            entry = getattr(lib, fn)
            entry.argtypes = argtypes
            entry.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib
