"""Video frames and task transforms (port of boosting_nerv_tpu/data/video.py).

The reference data layer, in numpy, in the same order of random draws as
the JAX package:
 - ``VideoData``: a sorted directory of PNG / JPG frames, center-cropped to
   ``crop_list`` (bicubic resize when a frame is smaller), ``norm_idx =
   (idx + 1) / N``; interpolation drops the last frame of an even count,
   and ``embed_inter`` gives odd (held-out) frames their even neighbours;
 - ``data_split``: of every ``c`` consecutive frames the first ``a`` are
   train, those at positions >= ``b`` validation;
 - ``make_inpaint_mask``: a static mask per resolution,
   ``inpanting_center`` zeroes a centred h/4 x w/4 box,
   ``inpanting_fixed_S`` five S x S boxes;
 - ``synthetic_video``: a deterministic moving-pattern clip for tests and
   smoke runs.

The whole clip is held as a host uint8 array; the trainer copies it to the
device once and converts to float there.  PNG frames are read by the
port's own reader (``data/png.py``), with no Pillow; Pillow is imported
only to read JPEG or BMP frames or to resize a frame smaller than the
crop, and without it those raise ImportError naming the file.  No recipe
under ``scripts/`` needs either.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .png import read_png

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp"}


def _center_crop(img: np.ndarray, ch: int, cw: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = (h - ch) // 2
    left = (w - cw) // 2
    return img[top:top + ch, left:left + cw]


def _pillow(path: str, why: str):
    """Pillow's ``Image`` module, or ImportError naming ``path`` and why it
    was needed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: {why} needs Pillow, which is not "
                          "installed (PNG frames of the crop's size or "
                          "larger need nothing)") from e
    return Image


def _read_frame(path: str) -> np.ndarray:
    """uint8 [H, W, 3] RGB of a PNG (the port's reader) or a JPEG / BMP
    (Pillow) frame."""
    if os.path.splitext(path)[1].lower() == ".png":
        return read_png(path)
    Image = _pillow(path, "reading a JPEG or BMP frame")
    return np.asarray(Image.open(path).convert("RGB"))


def _resize_bicubic(img: np.ndarray, ch: int, cw: int,
                    path: str = "a frame") -> np.ndarray:
    Image = _pillow(path, f"resizing a {img.shape[0]}x{img.shape[1]} frame "
                    f"to the crop {ch}x{cw}")
    return np.asarray(Image.fromarray(img).resize((cw, ch), Image.BICUBIC))


def data_split(img_list: List[int], split_num_list: Sequence[int],
               shuffle_data: bool = False, rand_num: int = 0
               ) -> Tuple[List[int], List[int]]:
    """Seen/unseen frame split (hnerv_utils.py:87-98)."""
    import random

    valid_train_length, total_train_length, total_data_length = split_num_list
    img_list = list(img_list)
    if shuffle_data:
        random.Random(rand_num).shuffle(img_list)
    train_list, val_list = [], []
    for cur_i, frame_id in enumerate(img_list):
        if (cur_i % total_data_length) < valid_train_length:
            train_list.append(frame_id)
        elif (cur_i % total_data_length) >= total_train_length:
            val_list.append(frame_id)
    return train_list, val_list


def make_inpaint_mask(h: int, w: int, spec: str) -> Optional[np.ndarray]:
    """Static [h, w] {0,1} mask, or None when inpainting is off."""
    if "inpanting" not in spec:
        return None
    mask = np.ones((h, w), dtype=np.float32)
    if "center" in spec:
        ih, iw = h // 8, w // 8
        cx, cy = int(0.5 * h), int(0.5 * w)
        mask[cx - ih:cx + ih, cy - iw:cy + iw] = 0
    elif "fixed" in spec:
        size = int(spec.split("_")[-1]) // 2
        for fx, fy in [(1 / 2, 1 / 2), (1 / 4, 1 / 4), (1 / 4, 3 / 4),
                       (3 / 4, 1 / 4), (3 / 4, 3 / 4)]:
            cx, cy = int(fx * h), int(fy * w)
            mask[cx - size:cx + size, cy - size:cy + size] = 0
    return mask


def synthetic_video(n_frames: int = 8, h: int = 64, w: int = 64,
                    seed: int = 0) -> np.ndarray:
    """Deterministic moving-pattern video for tests/benchmarks: uint8
    [N, H, W, 3] with smooth spatial gradients plus a moving bright square."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([ys / h, xs / w, (ys + xs) / (h + w)], axis=-1)
    frames = []
    phase = rng.uniform(0, np.pi)
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        img = 0.6 * base + 0.2 * np.sin(
            2 * np.pi * (xs / w * 3 + t) + phase)[..., None]
        cy = int((h - h // 4) * t)
        cx = int((w - w // 4) * (1 - t))
        img[cy:cy + h // 4, cx:cx + w // 4] += 0.3
        frames.append(np.clip(img, 0, 1))
    return (np.stack(frames) * 255).astype(np.uint8)


class VideoData:
    """In-memory video dataset."""

    def __init__(self, frames: np.ndarray, interpolation: bool = False,
                 embed_inter: bool = False):
        if interpolation and len(frames) % 2 == 0:
            frames = frames[:-1]
        self.frames = frames  # uint8 [N, H, W, 3]
        self.n = len(frames)
        self.embed_inter = embed_inter and interpolation
        self.final_size = frames.shape[1] * frames.shape[2]

    @classmethod
    def from_dir(cls, path: str, crop_list: str, interpolation: bool = False,
                 embed_inter: bool = False) -> "VideoData":
        ch, cw = [int(x) for x in crop_list.split("_")[:2]]
        names = sorted(x for x in os.listdir(path)
                       if os.path.splitext(x)[1].lower() in _IMG_EXTS)
        if not names:
            raise FileNotFoundError(f"no frames in {path}")
        out = []
        for name in names:
            frame_path = os.path.join(path, name)
            img = _read_frame(frame_path)
            h, w = img.shape[:2]
            if h >= ch and w >= cw:
                img = _center_crop(img, ch, cw)
            else:
                img = _resize_bicubic(img, ch, cw, frame_path)
            out.append(img)
        return cls(np.stack(out), interpolation, embed_inter)

    def norm_idx(self, idx: np.ndarray) -> np.ndarray:
        return (np.asarray(idx, dtype=np.float32) + 1.0) / self.n

    def neighbours(self, idx: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(pre, post) frame indices of ``idx`` for ``embed_inter``: an even
        frame is its own neighbour, an odd one has the even frames beside
        it (the last frame at the end of the clip)."""
        idx = np.asarray(idx, dtype=np.int64)
        even = idx % 2 == 0
        return (np.where(even, idx, idx - 1),
                np.where(even, idx, np.minimum(idx + 1, self.n - 1)))

    def get_batch(self, idx: Sequence[int]) -> dict:
        """Returns float32 NHWC images in [0,1] plus indices. For
        `embed_inter`, even frames neighbour themselves; odd frames get their
        even neighbours (hnerv_utils.py:48-54)."""
        idx = np.asarray(idx, dtype=np.int64)
        imgs = self.frames[idx].astype(np.float32) / 255.0
        batch = {"img": imgs, "idx": idx, "norm_idx": self.norm_idx(idx)}
        if self.embed_inter:
            pre, post = self.neighbours(idx)
            batch["pre_img"] = self.frames[pre].astype(np.float32) / 255.0
            batch["post_img"] = self.frames[post].astype(np.float32) / 255.0
        return batch

    def epoch_batches(self, indices: Sequence[int], batch_size: int,
                      shuffle: bool, seed: int, drop_last: bool = True):
        order = np.asarray(list(indices), dtype=np.int64)
        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(order)
        end = (len(order) // batch_size * batch_size) if drop_last else len(order)
        for s in range(0, end, batch_size):
            chunk = order[s:s + batch_size]
            if len(chunk):
                yield self.get_batch(chunk)
