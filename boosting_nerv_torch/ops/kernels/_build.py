"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

``nvcc`` compiles every source under ``ops/csrc`` into one shared library
with a plain C interface, for Hopper (``sm_90a``), at first use.  The
library's name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is loaded from ``boosting_nerv_torch/
build/``.  The library is bound with ``ctypes``: each pointer and the
stream is a ``c_void_p`` and each int a ``c_int``; every entry point
returns ``cudaGetLastError()`` after its launch, which ``check`` turns into
an exception.  Nothing here runs on import: the CPU tests import this
module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libbnt_kernels_{digest.hexdigest()[:16]}.so")


def build(path: str) -> None:
    """Compile every ``.cu`` source into ``path`` (atomically renamed)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cus = [s for s in _sources() if s.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bnt_stage_conv3x3.restype = ci
    lib.bnt_stage_conv3x3.argtypes = [vp] * 9 + [ci] * 7 + [vp]
    lib.bnt_stage_conv3x3_smem.restype = ci
    lib.bnt_stage_conv3x3_smem.argtypes = [ci, ci]
    lib.bnt_error_string.restype = ctypes.c_char_p
    lib.bnt_error_string.argtypes = [ci]
    return lib


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built first if its sources changed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            _LIB = _bind(ctypes.CDLL(path))
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load_library().bnt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
