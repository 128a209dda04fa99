"""Every kind of PNG through the port's reader (``data/png.py``) against
Pillow's ``Image.open(f).convert("RGB")``, exactly: grey at 1, 2, 4, 8 and
16 bits, RGB and RGBA at 8 and 16, a palette at 1, 2, 4 and 8 with and
without ``tRNS``, grey with alpha at 8 and 16, each plain and
Adam7-interlaced at 1x1, 3x5 and 13x17, every row filtered with a random
filter type.  The files are built here with ``zlib`` and ``struct``
(Pillow writes neither interlaced nor 16-bit RGB PNGs) and read through
``read_png`` and ``VideoData.from_dir``; malformed files raise ValueError
naming what is wrong."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from boosting_nerv_torch.data import VideoData, png
from test_torch_tasks_png import _chunk, _predict

SIZES = [(1, 1), (3, 5), (13, 17)]
# Adam7: (x0, y0, dx, dy) of each pass, as the PNG specification lists them
PASSES = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def _pack(samples, depth):
    """The bytes of one row of samples (ints): big-endian at 16 bits, MSB
    first below 8, the last byte padded with zero bits."""
    samples = np.asarray(samples, np.int64).ravel()
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    bits = ((samples[:, None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.astype(np.uint8).ravel()).tobytes()


def _filtered(img, depth, rng):
    """Scanlines of samples [H, W, C], each row behind a random filter
    type byte (an image of zero pixels has no bytes)."""
    h, w, c = img.shape
    if not (h and w):
        return b""
    bpp = max(1, c * depth // 8)
    out, prev = [], None
    for y in range(h):
        cur = np.frombuffer(_pack(img[y], depth), np.uint8).astype(int)
        prev = np.zeros_like(cur) if prev is None else prev
        kind = int(rng.integers(0, 5))
        out.append(bytes([kind]) + ((cur - _predict(kind, cur, prev, bpp))
                                    % 256).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def encode(img, colour, depth, interlace, rng, palette=None, trns=None):
    """A PNG of samples [H, W, C]: Adam7's seven passes each filtered as an
    image of its own when ``interlace``."""
    h, w, _ = img.shape
    if interlace:
        data = b"".join(_filtered(img[y0::dy, x0::dx], depth, rng)
                        for x0, y0, dx, dy in PASSES)
    else:
        data = _filtered(img, depth, rng)
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                          0, 0, interlace))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    if trns is not None:
        chunks.append(_chunk(b"tRNS", trns))
    z = zlib.compress(data)
    chunks += [_chunk(b"IDAT", z[:len(z) // 2]),
               _chunk(b"IDAT", z[len(z) // 2:]), _chunk(b"IEND", b"")]
    return png.SIGNATURE + b"".join(chunks)


def _check(tmp_path, name, data, shape):
    """``data`` read by the port, by ``read_png`` and through
    ``VideoData.from_dir``, equals Pillow's ``convert("RGB")`` exactly."""
    d = tmp_path / name
    d.mkdir()
    path = d / "0000.png"
    path.write_bytes(data)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = png.read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == (*shape, 3), name
    np.testing.assert_array_equal(got, want, err_msg=name)
    video = VideoData.from_dir(str(d), f"{shape[0]}_{shape[1]}")
    np.testing.assert_array_equal(video.frames[0], want, err_msg=name)
    return want


def _cases(colour, depths, channels):
    for depth in depths:
        for interlace in (0, 1):
            for h, w in SIZES:
                yield depth, interlace, (h, w, channels)


@pytest.mark.parametrize("colour,depths,channels", [
    (0, (1, 2, 4, 8, 16), 1),   # grey
    (2, (8, 16), 3),            # RGB
    (4, (8, 16), 2),            # grey with alpha
    (6, (8, 16), 4),            # RGBA
], ids=["grey", "RGB", "grey_alpha", "RGBA"])
def test_direct_colour_kinds_read_as_pillow_reads_them(colour, depths,
                                                       channels, tmp_path):
    rng = np.random.default_rng(colour)
    for depth, interlace, shape in _cases(colour, depths, channels):
        img = rng.integers(0, 1 << depth, shape)
        if depth == 16:  # small values too: 16-bit grey clips at 255
            img[::2] >>= 8
        want = _check(tmp_path, f"c{colour}_d{depth}_i{interlace}_"
                      f"{shape[0]}x{shape[1]}",
                      encode(img, colour, depth, interlace, rng),
                      shape[:2])
        if colour == 0 and depth == 16:
            np.testing.assert_array_equal(want[..., 0],
                                          np.minimum(img[..., 0], 255))
        elif depth == 16:
            np.testing.assert_array_equal(want, np.repeat(
                img[..., :1] >> 8, 3, axis=2) if channels < 3
                else img[..., :3] >> 8)
        elif colour == 0 and depth < 8:
            np.testing.assert_array_equal(
                want[..., 0], img[..., 0] * (255 // ((1 << depth) - 1)))


@pytest.mark.parametrize("trns", [False, True], ids=["plain", "tRNS"])
def test_palette_kinds_read_as_pillow_reads_them(trns, tmp_path):
    rng = np.random.default_rng(3 + trns)
    for depth, interlace, shape in _cases(3, (1, 2, 4, 8), 1):
        n = int(rng.integers(1, (1 << depth) + 1))  # a PLTE of n entries
        palette = rng.integers(0, 256, (n, 3))
        img = rng.integers(0, n, shape)
        alpha = (rng.integers(0, 256, int(rng.integers(1, n + 1)))
                 .astype(np.uint8).tobytes() if trns else None)
        want = _check(tmp_path, f"p_d{depth}_i{interlace}_{shape[0]}x"
                      f"{shape[1]}", encode(img, 3, depth, interlace, rng,
                                            palette, alpha), shape[:2])
        np.testing.assert_array_equal(want, palette[img[..., 0]])


def test_malformed_files_raise_naming_what_is_wrong():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 4, (3, 5, 1))
    pal = rng.integers(0, 256, (3, 3))
    for data, what in [
        (encode(img, 3, 2, 1, rng, pal), "palette index 3 is past the end "
                                         "of its 3-entry PLTE"),
        (encode(img, 3, 2, 0, rng), "no PLTE chunk"),
        (encode(img, 2, 4, 0, rng), "4-bit RGB"),
        (encode(img, 3, 16, 0, rng), "16-bit palette"),
        (encode(img, 4, 4, 1, rng), "4-bit grey with alpha"),
        (encode(img, 0, 2, 2, rng), "interlace method 2"),
        (encode(img, 0, 2, 1, rng)[:33] + _chunk(
            b"IDAT", zlib.compress(b"\0" * 9)) + _chunk(b"IEND", b""),
         r"holds 9 bytes, expected \d+ for 5x3 2-bit grey \(Adam7\)"),
    ]:
        with pytest.raises(ValueError, match=what):
            png.decode_png(data)
    # a bad filter type in an interlaced file names its pass
    raw = bytearray(zlib.decompress(
        b"".join(p for k, p in png._chunks(encode(img, 0, 8, 1, rng))
                 if k == b"IDAT")))
    raw[0] = 7
    bad = (encode(img, 0, 8, 1, rng)[:33]
           + _chunk(b"IDAT", zlib.compress(bytes(raw)))
           + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="Adam7 pass 1 row 0 has filter "
                                         "type 7"):
        png.decode_png(bad)
