"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

``nvcc`` compiles every ``.cu`` source under ``ops/csrc`` for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, at first use.
The library's name carries a hash of the sources (headers included) and
flags, so an edited source builds anew and an unchanged one is loaded from
``boosting_nerv_torch/build/``; ptxas's register and spill report is kept
beside it (``<library>.log``, one ``# <source>`` section per source).  The
library is bound with ``ctypes``: each pointer and the stream is a
``c_void_p``, each int a ``c_int`` and each float a ``c_float``; every
entry point returns
``cudaGetLastError()`` after its launch, which ``check`` turns into an
exception.  Nothing here runs on import: the CPU tests import this module
on machines without ``nvcc``.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

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
    """Compile every ``.cu`` source in parallel and link them into ``path``
    (atomically renamed); ptxas's report goes to ``path + ".log"``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cus = [s for s in _sources() if s.endswith(".cu")]
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cus]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                for s, o in zip(cus, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        runs = [(c, p.returncode, log) for c, p, log in zip(cmds, procs, logs)]
        for cmd, rc, log in runs + [(link, res.returncode,
                                     res.stdout + res.stderr)]:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{log}")
        with open(path + ".log", "w") as f:
            f.write("".join(f"# {os.path.basename(s)}\n{log}"
                            for s, log in zip(cus, logs)))
        os.replace(lib, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bnt_stage_conv.restype = ci
    lib.bnt_stage_conv.argtypes = [vp] * 10 + [ci] * 9 + [vp]
    lib.bnt_stage_conv_smem.restype = ci
    lib.bnt_stage_conv_smem.argtypes = [ci, ci, ci]
    lib.bnt_stage_conv3x3_i8.restype = ci
    lib.bnt_stage_conv3x3_i8.argtypes = [vp] * 12 + [ci] * 8 + [vp]
    lib.bnt_stage_conv3x3_i8_smem.restype = ci
    lib.bnt_stage_conv3x3_i8_smem.argtypes = [ci, ci]
    lib.bnt_conv_sm90.restype = ci
    lib.bnt_conv_sm90.argtypes = [vp] * 10 + [ci] * 9 + [vp]
    lib.bnt_conv_sm90_smem.restype = ci
    lib.bnt_conv_sm90_smem.argtypes = [ci] * 4
    lib.bnt_conv_sm90_at.restype = ci
    lib.bnt_conv_sm90_at.argtypes = [vp] * 10 + [ci] * 11 + [vp]
    lib.bnt_conv_sm90_groups.restype = ci
    lib.bnt_conv_sm90_groups.argtypes = [ci] * 7 + [vp]
    lib.bnt_conv_sm90_kloop.restype = ci
    lib.bnt_conv_sm90_kloop.argtypes = [vp] * 10 + [ci] * 9 + [vp] * 2
    lib.bnt_conv_sm90_kloop_smem.restype = ci
    lib.bnt_conv_sm90_kloop_smem.argtypes = [ci] * 4
    lib.bnt_conv_sm90_sin.restype = ci
    lib.bnt_conv_sm90_sin.argtypes = [vp] * 9 + [ci] * 9 + [vp] * 2
    lib.bnt_conv_sm90_planar.restype = ci
    lib.bnt_conv_sm90_planar.argtypes = [vp] * 9 + [ci] * 11 + [vp] * 2
    lib.bnt_conv_sm90_planar_smem.restype = ci
    lib.bnt_conv_sm90_planar_smem.argtypes = [ci] * 4
    lib.bnt_conv_sm90_i8.restype = ci
    lib.bnt_conv_sm90_i8.argtypes = [vp] * 12 + [ci] * 9 + [vp]
    lib.bnt_conv_sm90_i8_smem.restype = ci
    lib.bnt_conv_sm90_i8_smem.argtypes = [ci] * 5
    lib.bnt_error_string.restype = ctypes.c_char_p
    lib.bnt_error_string.argtypes = [ci]
    # the probes (ops/kernels/probes.py)
    lib.bnt_stage_conv_probe.restype = ci
    lib.bnt_stage_conv_probe.argtypes = [vp] * 9 + [ci] * 8 + [vp]
    lib.bnt_stage_conv3x3_i8_probe.restype = ci
    lib.bnt_stage_conv3x3_i8_probe.argtypes = [vp] * 12 + [ci] * 9 + [vp]
    lib.bnt_stage_conv3x3_i8_probe_smem.restype = ci
    lib.bnt_stage_conv3x3_i8_probe_smem.argtypes = [ci] * 4
    lib.bnt_gemm_probe.restype = ci
    lib.bnt_gemm_probe.argtypes = ([vp] * 3 + [ci] * 10
                                   + [ctypes.c_float, ci, vp])
    lib.bnt_gemm_probe_smem.restype = ci
    lib.bnt_gemm_probe_smem.argtypes = [ci] * 6
    lib.bnt_gemm_probe_fill.restype = ci
    lib.bnt_gemm_probe_fill.argtypes = [ci] * 7
    lib.bnt_stage_build_probe.restype = ci
    lib.bnt_stage_build_probe.argtypes = [vp] * 6 + [ci] * 6 + [vp]
    lib.bnt_conv_sm90_probe.restype = ci
    lib.bnt_conv_sm90_probe.argtypes = [vp] * 10 + [ci] * 10 + [vp]
    lib.bnt_conv_sm90_i8_probe.restype = ci
    lib.bnt_conv_sm90_i8_probe.argtypes = [vp] * 12 + [ci] * 10 + [vp]
    lib.bnt_stage_build_probe_smem.restype = ci
    lib.bnt_stage_build_probe_smem.argtypes = [ci] * 2
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
