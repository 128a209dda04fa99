"""PNG frames without Pillow: the reader and writer of the port's clips and
dumped frames.

- ``decode_png`` / ``read_png``: every kind of PNG the specification
  allows (grey at 1, 2, 4, 8 and 16 bits, RGB and RGBA at 8 and 16, a
  palette at 1, 2, 4 and 8, grey with alpha at 8 and 16, each also
  Adam7-interlaced) to uint8 HWC RGB exactly as Pillow's
  ``Image.open(f).convert("RGB")`` gives it: grey below 8 bits scaled to
  0-255 (x 255, 85, 17), 16-bit colour and grey with alpha by the high
  byte, 16-bit grey clipped at 255 (Pillow's ``I;16`` path), a palette
  looked up in ``PLTE``, grey repeated on three channels, alpha and
  ``tRNS`` dropped.  The chunks are parsed and CRC-checked here, the IDAT
  stream inflated with ``zlib``, and the five row filters undone by
  ``csrc/png_unfilter.cpp`` (Sub, Average and Paeth depend on the byte to
  the left, which numpy cannot vectorise), compiled with g++ at first use
  into ``boosting_nerv_torch/build/libpng_unfilter.so`` (``utils.gxx``; a
  failed build raises, nothing falls back); each of Adam7's seven passes
  is un-filtered as an image of its own.  A malformed file (a depth its
  colour type does not allow, a palette index past the end of ``PLTE``,
  image data of the wrong length, a bad filter type or CRC) raises
  ValueError naming what is wrong.
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
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}  # colour type -> the bit depths PNG allows
COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey with alpha",
                6: "RGBA"}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
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


def _passes(w: int, h: int, interlace: int):
    """(x0, y0, dx, dy, width, height) of every pass with pixels: the
    whole image, or Adam7's passes (one of zero width or height has no
    bytes at all, not even a filter byte)."""
    if not interlace:
        return [(0, 0, 1, 1, w, h)]
    out = []
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def _samples(rows: np.ndarray, width: int, c: int, depth: int
             ) -> np.ndarray:
    """The samples [H, width, c] of un-filtered rows [H, stride] (uint8,
    or uint16 at 16 bits); sub-byte samples MSB first, a row's trailing
    bits ignored."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)[:, :width * c].reshape(
            h, width, c)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = (bits * weights).sum(axis=2, dtype=np.uint8)
        return vals[:, :width * c].reshape(h, width, c)
    return rows[:, :width * c].reshape(h, width, c)


def _to_rgb(px: np.ndarray, colour: int, depth: int,
            palette: Optional[np.ndarray]) -> np.ndarray:
    """uint8 [H, W, 3] of samples ``px`` as Pillow's ``convert("RGB")``."""
    if colour == 3:
        if palette is None:
            raise ValueError("PNG palette image has no PLTE chunk")
        idx = px[..., 0]
        if idx.size and int(idx.max()) >= len(palette):
            raise ValueError(f"PNG palette index {int(idx.max())} is past "
                             f"the end of its {len(palette)}-entry PLTE")
        return palette[idx]
    if depth == 16:
        # Pillow: 16-bit grey opens as I;16 and clips at 255; 16-bit RGB,
        # RGBA and grey with alpha keep the high byte
        px = (np.minimum(px, 255) if colour == 0 else px >> 8)
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    px = px.astype(np.uint8)
    if colour in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """The image of PNG file bytes ``data`` as uint8 [H, W, 3] RGB."""
    header, idat, palette = None, [], None
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            if len(payload) != 13:
                raise ValueError(f"PNG IHDR holds {len(payload)} bytes, "
                                 "not 13")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            if len(payload) % 3 or not payload:
                raise ValueError(f"PNG PLTE of {len(payload)} bytes (a "
                                 "multiple of 3 from 3)")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, compression, filt, interlace = header
    kind = f"{depth}-bit {COLOUR_NAMES.get(colour, f'colour type {colour}')}"
    if depth not in DEPTHS.get(colour, ()):
        raise ValueError(f"unsupported PNG: {kind} (PNG allows "
                         f"{DEPTHS.get(colour, 'no depth')})")
    if compression or filt or interlace > 1:
        raise ValueError(f"unsupported PNG: compression method "
                         f"{compression}, filter method {filt}, interlace "
                         f"method {interlace}")
    if not (w and h):
        raise ValueError(f"PNG of {w}x{h} pixels")
    c = CHANNELS[colour]
    bpp = max(1, c * depth // 8)  # bytes of a complete pixel, at least 1
    passes = _passes(w, h, interlace)
    strides = [-(-(pw * c * depth) // 8) for *_, pw, _ in passes]
    raw = zlib.decompress(b"".join(idat))
    want = sum(ph * (s + 1) for (*_, ph), s in zip(passes, strides))
    if len(raw) != want:
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{want} for {w}x{h} {kind}"
                         + (" (Adam7)" if interlace else ""))
    src = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((h, w, 3), dtype=np.uint8)
    pos = 0
    for p, ((x0, y0, dx, dy, pw, ph), stride) in enumerate(
            zip(passes, strides)):
        part = src[pos:pos + ph * (stride + 1)]
        rows = np.empty((ph, stride), dtype=np.uint8)
        bad = _lib().png_unfilter(part.ctypes.data_as(_U8P),
                                  rows.ctypes.data_as(_U8P), ph, stride,
                                  bpp)
        if bad:
            where = f"Adam7 pass {p + 1} " if interlace else ""
            raise ValueError(f"PNG {where}row {bad - 1} has filter type "
                             f"{part[(bad - 1) * (stride + 1)]} (0-4 only)")
        out[y0::dy, x0::dx] = _to_rgb(_samples(rows, pw, c, depth), colour,
                                      depth, palette)
        pos += ph * (stride + 1)
    return out


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
