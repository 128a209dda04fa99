"""The port's PNG reader and writer (``data/png.py``) and GIF writer
(``data/gif.py``), with Pillow as the independent reader: every row filter
in grey, RGB and RGBA decodes as Pillow decodes it, the writer's files read
back exactly in Pillow, the GIF opens in Pillow, kinds of PNG the
specification does not allow raise,
and ``VideoData.from_dir`` reads PNG frames with Pillow blocked."""

import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from boosting_nerv_torch.data import VideoData, gif, png, synthetic_video

# colour type -> (name, channels)
KINDS = {0: ("grey", 1), 2: ("RGB", 3), 6: ("RGBA", 4)}


def _predict(kind, cur, prev, bpp):
    """The predictor of filter ``kind`` for a row ``cur`` (ints) under the
    row ``prev``: vectorised, since the encoder knows every raw byte."""
    a = np.concatenate([np.zeros(bpp, int), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
    b = prev
    if kind == 0:
        return np.zeros_like(cur)
    if kind == 1:
        return a
    if kind == 2:
        return b
    if kind == 3:
        return (a + b) // 2
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode(img, colour, filters=(0, 1, 2, 3, 4), depth=8, interlace=0):
    """A PNG of uint8 [H, W, C] ``img`` whose row y is filtered
    ``filters[y % len(filters)]``, its data split over two IDAT chunks."""
    h, w, ch = img.shape
    rows, prev = [], np.zeros(w * ch, int)
    for y in range(h):
        cur = img[y].reshape(-1).astype(int)
        kind = filters[y % len(filters)]
        rows.append(bytes([kind]) + ((cur - _predict(kind, cur, prev, ch))
                                     % 256).astype(np.uint8).tobytes())
        prev = cur
    data = zlib.compress(b"".join(rows))
    half = len(data) // 2
    return (png.SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                          0, interlace))
            + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("colour", sorted(KINDS))
def test_every_filter_decodes_as_pillow_decodes_it(colour, tmp_path):
    name, ch = KINDS[colour]
    img = np.random.default_rng(colour).integers(0, 256, (11, 7, ch),
                                                 dtype=np.uint8)
    path = tmp_path / f"{name}.png"
    path.write_bytes(encode(img, colour))
    with Image.open(path) as im:
        assert np.array_equal(np.asarray(im).reshape(img.shape), img)
        want = np.asarray(im.convert("RGB"))
    got = png.read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == (11, 7, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.repeat(img, 3, axis=2) if ch == 1
                                  else img[..., :3])


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (33, 64)])
def test_writer_reads_back_exactly_in_pillow(shape, tmp_path):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    path = tmp_path / "w.png"
    png.write_png(str(path), img)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


def test_gif_opens_in_pillow_within_half_a_palette_step(tmp_path):
    frames = synthetic_video(3, 13, 21, seed=5)
    path = tmp_path / "v.gif"
    assert gif.write_gif(str(path), frames) == 3
    half = [np.diff(lv.astype(int)).max() / 2 for lv in gif.PALETTE_LEVELS]
    with Image.open(path) as im:
        assert (im.n_frames, im.size) == (3, (21, 13))
        for k, f in enumerate(frames):
            im.seek(k)
            err = np.abs(np.asarray(im.convert("RGB")).astype(int)
                         - f.astype(int)).max(axis=(0, 1))
            assert (err <= half).all(), (k, err, half)
    assert gif.gif_layout(path.read_bytes()) == ((21, 13),
                                                 [(0, 0, 21, 13)] * 3)
    with pytest.raises(ValueError, match="frame 1"):
        gif.write_gif(str(path), [frames[0], frames[1, :12]])


@pytest.mark.parametrize("kind,write", [
    # depths and colour types PNG does not allow; every allowed kind
    # decodes (tests/test_torch_png_kinds.py)
    ("4-bit RGB", lambda p: open(p, "wb").write(encode(
        np.zeros((3, 4, 3), np.uint8), 2, depth=4))),
    ("16-bit palette", lambda p: open(p, "wb").write(encode(
        np.zeros((3, 4, 1), np.uint8), 3, depth=16))),
    ("2-bit grey with alpha", lambda p: open(p, "wb").write(encode(
        np.zeros((3, 4, 2), np.uint8), 4, depth=2))),
    ("8-bit colour type 5", lambda p: open(p, "wb").write(encode(
        np.zeros((3, 4, 3), np.uint8), 5))),
])
def test_other_kinds_of_png_raise_naming_the_kind(kind, write, tmp_path):
    path = str(tmp_path / "x.png")
    write(path)
    with pytest.raises(ValueError, match=kind):
        png.read_png(path)


def test_a_bad_filter_type_raises(tmp_path):
    data = bytearray(encode(np.zeros((4, 3, 3), np.uint8), 2, filters=(0,)))
    # rewrite row 2's filter byte to 5 inside a fresh IDAT
    raw = bytearray(b"".join(bytes([0]) + bytes(9) for _ in range(4)))
    raw[2 * 10] = 5
    head = bytes(data[:8 + 25])  # the signature and IHDR
    bad = head + _chunk(b"IDAT", zlib.compress(bytes(raw))) + \
        _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="row 2 has filter type 5"):
        png.decode_png(bad)
    with pytest.raises(ValueError, match="corrupt"):
        png.decode_png(head[:-1] + b"\x00" + _chunk(b"IEND", b""))


def test_from_dir_reads_png_with_pillow_blocked(tmp_path, monkeypatch):
    frames = synthetic_video(3, 12, 20, seed=6)
    for i, f in enumerate(frames):
        png.write_png(str(tmp_path / f"{i:04d}.png"), f)
    monkeypatch.setitem(sys.modules, "PIL", None)  # importing it raises
    got = VideoData.from_dir(str(tmp_path), "8_16")
    np.testing.assert_array_equal(got.frames, frames[:, 2:10, 2:18])
    with pytest.raises(ImportError, match="0000.png: resizing"):
        VideoData.from_dir(str(tmp_path), "16_24")
    (tmp_path / "0003.jpg").write_bytes(b"")
    with pytest.raises(ImportError, match="0003.jpg: reading a JPEG"):
        VideoData.from_dir(str(tmp_path), "8_16")
