"""A GIF89a writer without Pillow or imageio: the preview of a run's dumped
frames (``gt_pred.gif``).

- One fixed global palette of 6 x 7 x 6 = 252 colours (red, green, blue
  levels evenly spaced over 0-255, rounded); each channel is mapped to its
  nearest level, so a channel's error is at most half the largest gap
  between two of its levels (25.5 for red and blue, 21.5 for green).
- LZW without a dictionary search: every pixel is sent as a literal code,
  and a clear code every ``LITERALS_PER_CLEAR`` literals keeps the code
  table below 512 entries, so every code is 9 bits wide and the encoder is
  numpy bit packing.  The stream is about 9 bits a pixel.
- One graphic control extension (4 centiseconds a frame) and one image
  descriptor a frame, the frames the size of the logical screen, looping
  forever (the NETSCAPE2.0 extension).

``gif_layout`` walks a GIF's blocks and returns its screen size and the
frame rectangles of its image descriptors.
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Tuple

import numpy as np

LEVELS = (6, 7, 6)  # red, green, blue
PALETTE_LEVELS = [np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8)
                  for n in LEVELS]
LITERALS_PER_CLEAR = 254
MIN_CODE_SIZE = 8
CLEAR, END = 1 << MIN_CODE_SIZE, (1 << MIN_CODE_SIZE) + 1
CODE_BITS = MIN_CODE_SIZE + 1
DELAY_CS = 4


def _nearest(levels: np.ndarray) -> np.ndarray:
    """uint8 value -> index of its nearest level (the lower on a tie)."""
    d = np.abs(np.arange(256)[:, None] - levels[None, :].astype(np.int64))
    return np.argmin(d, axis=1).astype(np.uint16)


_LUTS = [_nearest(lv) for lv in PALETTE_LEVELS]


def palette() -> np.ndarray:
    """The global colour table, uint8 [256, 3] (entries 252-255 black)."""
    r, g, b = np.meshgrid(*PALETTE_LEVELS, indexing="ij")
    table = np.zeros((256, 3), dtype=np.uint8)
    table[:r.size] = np.stack([r.ravel(), g.ravel(), b.ravel()], axis=1)
    return table


def palette_indices(img: np.ndarray) -> np.ndarray:
    """The palette index of every pixel of uint8 [H, W, 3] ``img``."""
    r, g, b = (_LUTS[c][img[..., c]] for c in range(3))
    return (r * (LEVELS[1] * LEVELS[2]) + g * LEVELS[2] + b).ravel()


def lzw_literals(indices: np.ndarray) -> bytes:
    """The LZW data of ``indices`` (< 256) as 9-bit literal codes, a clear
    code first and every ``LITERALS_PER_CLEAR`` literals, the end code
    last, packed least significant bit first."""
    n = indices.size
    n_clear = (n + LITERALS_PER_CLEAR - 1) // LITERALS_PER_CLEAR
    codes = np.empty(n + n_clear + 1, dtype=np.uint16)
    pos = np.arange(n) + np.arange(n) // LITERALS_PER_CLEAR + 1
    codes[pos] = indices
    codes[np.arange(n_clear) * (LITERALS_PER_CLEAR + 1)] = CLEAR
    codes[-1] = END
    bits = (codes[:, None] >> np.arange(CODE_BITS, dtype=np.uint16)) & 1
    return np.packbits(bits.astype(np.uint8).ravel(),
                       bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    """``data`` as GIF data sub-blocks of at most 255 bytes, each behind its
    length byte, then the zero-length terminator."""
    out = bytearray()
    for s in range(0, len(data), 255):
        chunk = data[s:s + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames: Iterable[np.ndarray]) -> int:
    """Write uint8 [H, W, 3] ``frames`` (all one size) as an animated GIF
    to ``path``, one frame at a time; returns the number of frames."""
    n, size = 0, None
    with open(path, "wb") as f:
        for img in frames:
            img = np.asarray(img)
            if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
                raise ValueError(f"write_gif takes uint8 [H, W, 3] frames, "
                                 f"got {img.dtype} {img.shape}")
            h, w = img.shape[:2]
            if size is None:
                size = (h, w)
                f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
                f.write(palette().tobytes())
                f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
            elif (h, w) != size:
                raise ValueError(f"frame {n} is {h}x{w}, the first "
                                 f"{size[0]}x{size[1]}")
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", DELAY_CS)
                    + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(bytes([MIN_CODE_SIZE])
                    + _sub_blocks(lzw_literals(palette_indices(img))))
            n += 1
        if size is None:
            raise ValueError("write_gif needs at least one frame")
        f.write(b"\x3b")
    return n


def gif_layout(data: bytes) -> Tuple[Tuple[int, int],
                                     List[Tuple[int, int, int, int]]]:
    """((screen width, height), [(left, top, width, height) of each image
    descriptor]) of GIF file bytes ``data``, by walking its blocks."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file (bad signature)")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13
    if packed & 0x80:
        pos += 3 << ((packed & 7) + 1)
    frames = []

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while True:
        tag = data[pos]
        if tag == 0x3B:
            return (w, h), frames
        if tag == 0x21:  # an extension: label, then sub-blocks
            pos = skip_sub_blocks(pos + 2)
        elif tag == 0x2C:
            left, top, fw, fh, fp = struct.unpack("<HHHHB",
                                                  data[pos + 1:pos + 10])
            frames.append((left, top, fw, fh))
            pos += 10
            if fp & 0x80:
                pos += 3 << ((fp & 7) + 1)
            pos = skip_sub_blocks(pos + 1)  # past the LZW code size
        else:
            raise ValueError(f"unexpected GIF block 0x{tag:02x} at {pos}")
