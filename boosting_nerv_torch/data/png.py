"""PNG frames without Pillow: the reader and writer of the port's clips and
dumped frames.

- ``decode_png`` / ``read_png``: 8-bit grey, RGB and RGBA, not
  interlaced, to uint8 HWC RGB as Pillow's ``Image.open(f).convert("RGB")``
  gives it (grey repeated on three channels, alpha dropped).  The chunks
  are parsed and CRC-checked here, the IDAT stream inflated with
  ``zlib``, and the five row filters undone by ``csrc/png_unfilter.cpp``
  (Sub, Average and Paeth depend on the byte to the left, which numpy
  cannot vectorise), compiled with g++ at first use into
  ``boosting_nerv_torch/build/libpng_unfilter.so`` (``utils.gxx``; a
  failed build raises, nothing falls back).  Any other kind of PNG
  (another bit depth, a palette, grey with alpha, interlacing) raises
  ValueError naming it.
- ``encode_png`` / ``write_png``: uint8 HWC RGB, every row filtered Sub
  in numpy, deflated with ``zlib`` at level 6 (Pillow's default).
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from ..utils.gxx import BUILD_DIR, build_shared

SRC = os.path.join(os.path.dirname(__file__), "csrc", "png_unfilter.cpp")
LIB = os.path.join(BUILD_DIR, "libpng_unfilter.so")
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel
COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey with alpha",
                6: "RGBA"}
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            build_shared(SRC, LIB)
            lib = ctypes.CDLL(LIB)
            lib.png_unfilter.restype = ctypes.c_long
            lib.png_unfilter.argtypes = [_U8P, _U8P, ctypes.c_long,
                                         ctypes.c_long, ctypes.c_int]
            _LIB = lib
    return _LIB


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRC-checked, through IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or corrupt")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """The image of PNG file bytes ``data`` as uint8 [H, W, 3] RGB."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, compression, filt, interlace = header
    kind = f"{depth}-bit {COLOUR_NAMES.get(colour, f'colour type {colour}')}"
    if depth != 8 or colour not in CHANNELS:
        raise ValueError(f"unsupported PNG: {kind} (8-bit grey, RGB or RGBA "
                         "only)")
    if interlace:
        raise ValueError(f"unsupported PNG: interlaced {kind}")
    if compression or filt:
        raise ValueError(f"unsupported PNG: compression method "
                         f"{compression}, filter method {filt}")
    c = CHANNELS[colour]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{h * (stride + 1)} for {w}x{h} {kind}")
    src = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((h, w, c), dtype=np.uint8)
    bad = _lib().png_unfilter(src.ctypes.data_as(_U8P),
                              out.ctypes.data_as(_U8P), h, stride, c)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type "
                         f"{raw[(bad - 1) * (stride + 1)]} (0-4 only)")
    if c == 1:
        return np.repeat(out, 3, axis=2)
    return np.ascontiguousarray(out[..., :3]) if c == 4 else out


def read_png(path: str) -> np.ndarray:
    """``decode_png`` of the file ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img: np.ndarray) -> bytes:
    """PNG file bytes of uint8 [H, W, 3] RGB ``img``: 8-bit RGB, every row
    filtered Sub (each byte minus the one a pixel to its left)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.empty((h, 1 + 3 * w), dtype=np.uint8)
    rows[:, 0] = 1  # Sub
    flat = img.reshape(h, 3 * w)
    rows[:, 1:4] = flat[:, :3]
    np.subtract(flat[:, 3:], flat[:, :-3], out=rows[:, 4:])  # mod 256
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """``encode_png`` of ``img`` into the file ``path``."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
