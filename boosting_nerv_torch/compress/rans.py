"""The rANS codec of the CEM coding eval (port of
boosting_nerv_tpu/compress/rans.py): a ctypes binding of the port's own
copy of the C++ codec, ``compress/csrc/rans.cpp``.

``gaussian_ans_bits`` is the real compressed size in bits of an integer
tensor under the global quantized-Gaussian model; encode and decode round
trip losslessly; ``categorical_ans_*`` code an empirical symbol table.

The library is compiled at first use into
``boosting_nerv_torch/build/librans.so`` (``utils.gxx.build_shared``:
g++, rebuilt when the source is newer, once under a lock file; a failed
build raises and nothing falls back).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from ..utils.gxx import BUILD_DIR, build_shared

SRC = os.path.join(os.path.dirname(__file__), "csrc", "rans.cpp")
LIB = os.path.join(BUILD_DIR, "librans.so")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_F64P = ctypes.POINTER(ctypes.c_double)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            build_shared(SRC, LIB)
            lib = ctypes.CDLL(LIB)
            lib.rans_gaussian_encode.restype = ctypes.c_long
            lib.rans_gaussian_encode.argtypes = [
                _I32P, ctypes.c_long, ctypes.c_double, ctypes.c_double,
                ctypes.c_int32, ctypes.c_int32, _U32P, ctypes.c_long]
            lib.rans_gaussian_decode.restype = ctypes.c_long
            lib.rans_gaussian_decode.argtypes = [
                _U32P, ctypes.c_long, ctypes.c_long, ctypes.c_double,
                ctypes.c_double, ctypes.c_int32, ctypes.c_int32, _I32P]
            lib.rans_categorical_encode.restype = ctypes.c_long
            lib.rans_categorical_encode.argtypes = [
                _I32P, ctypes.c_long, _F64P, ctypes.c_int, _U32P,
                ctypes.c_long]
            lib.rans_categorical_decode.restype = ctypes.c_long
            lib.rans_categorical_decode.argtypes = [
                _U32P, ctypes.c_long, ctypes.c_long, _F64P, ctypes.c_int,
                _I32P]
            _LIB = lib
    return _LIB


def _model_range(symbols: np.ndarray) -> Tuple[int, int]:
    """min / max, one apart at least (the reference's fix of a constant
    tensor's degenerate range)."""
    min_v = int(symbols.min())
    max_v = int(symbols.max())
    if min_v == max_v:
        max_v = min_v + 1
    return min_v, max_v


def _int32(symbols) -> np.ndarray:
    sym = np.ascontiguousarray(np.asarray(symbols).ravel(), dtype=np.int32)
    if sym.size == 0:
        raise ValueError("rANS needs at least one symbol")
    return sym


def gaussian_ans_encode(symbols: np.ndarray, mean: float, std: float
                        ) -> Tuple[np.ndarray, int, int]:
    """Encode integer symbols; (stream words, min_v, max_v)."""
    sym = _int32(symbols)
    std = float(np.clip(std, 1e-5, 1e10))
    min_v, max_v = _model_range(sym)
    cap = sym.size + 16
    out = np.empty(cap, dtype=np.uint32)
    n = _lib().rans_gaussian_encode(
        sym.ctypes.data_as(_I32P), sym.size, float(mean), std, min_v, max_v,
        out.ctypes.data_as(_U32P), cap)
    if n < 0:
        raise RuntimeError("rANS output buffer overflow (incompressible data)")
    return out[:n].copy(), min_v, max_v


def gaussian_ans_decode(stream: np.ndarray, n_symbols: int, mean: float,
                        std: float, min_v: int, max_v: int) -> np.ndarray:
    stream = np.ascontiguousarray(stream, dtype=np.uint32)
    std = float(np.clip(std, 1e-5, 1e10))
    out = np.empty(n_symbols, dtype=np.int32)
    r = _lib().rans_gaussian_decode(
        stream.ctypes.data_as(_U32P), stream.size, n_symbols, float(mean),
        std, min_v, max_v, out.ctypes.data_as(_I32P))
    if r != 0:
        raise RuntimeError("rANS decode failed")
    return out


def gaussian_ans_bits(symbols: np.ndarray, mean: float, std: float) -> int:
    """Real compressed size in bits (32 a stream word)."""
    stream, _, _ = gaussian_ans_encode(symbols, mean, std)
    return int(stream.size) * 32


def categorical_ans_encode(values: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ANS coding of an integer tensor under its empirical symbol table:
    (stream words, the unique values, their counts)."""
    vals = np.asarray(values).ravel()
    if vals.size == 0:
        raise ValueError("rANS needs at least one symbol")
    unique, inverse, counts = np.unique(vals, return_inverse=True,
                                        return_counts=True)
    probs = np.ascontiguousarray(counts / counts.sum(), dtype=np.float64)
    msg = np.ascontiguousarray(inverse.ravel(), dtype=np.int32)
    cap = msg.size + 16
    out = np.empty(cap, dtype=np.uint32)
    n = _lib().rans_categorical_encode(
        msg.ctypes.data_as(_I32P), msg.size, probs.ctypes.data_as(_F64P),
        probs.size, out.ctypes.data_as(_U32P), cap)
    if n < 0:
        raise RuntimeError(f"categorical rANS encode failed ({n})")
    return out[:n].copy(), unique, counts


def categorical_ans_decode(stream: np.ndarray, n_symbols: int,
                           unique: np.ndarray, counts: np.ndarray
                           ) -> np.ndarray:
    stream = np.ascontiguousarray(stream, dtype=np.uint32)
    probs = np.ascontiguousarray(counts / counts.sum(), dtype=np.float64)
    idx = np.empty(n_symbols, dtype=np.int32)
    r = _lib().rans_categorical_decode(
        stream.ctypes.data_as(_U32P), stream.size, n_symbols,
        probs.ctypes.data_as(_F64P), probs.size, idx.ctypes.data_as(_I32P))
    if r != 0:
        raise RuntimeError("categorical rANS decode failed")
    return np.asarray(unique)[idx]
