"""The port's data, PTQ, Huffman and logging modules against the JAX
package's on the CPU: the same inputs, drawn with numpy from a seed, give
identical outputs (these are numpy on both sides, so equality is exact)."""

import dataclasses
import os

import numpy as np
import pytest
import yaml

from boosting_nerv_torch.compress.huffman import huffman_code_lengths
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.data import video as port_video
from boosting_nerv_torch.ops.ptq import dequant_tensor, quant_tensor
from boosting_nerv_torch.utils.logger import RunLogger
from boosting_nerv_tpu.compress import huffman as ref_huffman
from boosting_nerv_tpu.data import video as ref_video
from boosting_nerv_tpu.ops import ptq as ref_ptq
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger


@pytest.mark.parametrize("n,h,w,seed", [(8, 16, 24, 0), (5, 33, 17, 3)])
def test_synthetic_video_crop_and_resize_match_jax(n, h, w, seed):
    got = port_video.synthetic_video(n, h, w, seed)
    np.testing.assert_array_equal(got, ref_video.synthetic_video(n, h, w,
                                                                 seed))
    img = got[0]
    np.testing.assert_array_equal(port_video._center_crop(img, 8, 9),
                                  ref_video._center_crop(img, 8, 9))
    np.testing.assert_array_equal(port_video._resize_bicubic(img, 40, 30),
                                  ref_video._resize_bicubic(img, 40, 30))


@pytest.mark.parametrize("split,shuffle", [([1, 1, 1], False),
                                           ([3, 4, 5], False),
                                           ([1, 1, 2], True),
                                           ([6, 8, 10], True)])
def test_data_split_matches_jax(split, shuffle):
    frames = list(range(37))
    assert port_video.data_split(frames, split, shuffle, 4) == \
        ref_video.data_split(frames, split, shuffle, 4)


@pytest.mark.parametrize("spec", ["none", "inpanting_center",
                                  "inpanting_fixed_6", "inpanting_fixed_10"])
def test_inpaint_mask_matches_jax(spec):
    got = port_video.make_inpaint_mask(48, 64, spec)
    want = ref_video.make_inpaint_mask(48, 64, spec)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interp,embed_inter", [(False, False),
                                                (True, True)])
def test_video_data_batches_match_jax(interp, embed_inter):
    frames = port_video.synthetic_video(6, 8, 12, seed=2)
    a = port_video.VideoData(frames, interp, embed_inter)
    b = ref_video.VideoData(frames, interp, embed_inter)
    assert (a.n, a.final_size, a.embed_inter) == (b.n, b.final_size,
                                                  b.embed_inter)
    for shuffle, drop_last in ((True, True), (False, False)):
        for seed in (1, 2, 7):
            got = list(a.epoch_batches(range(a.n), 2, shuffle, seed,
                                       drop_last))
            want = list(b.epoch_batches(range(b.n), 2, shuffle, seed,
                                        drop_last))
            assert len(got) == len(want)
            for x, y in zip(got, want):
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])


def test_video_data_from_dir_matches_jax(tmp_path):
    from PIL import Image

    frames = port_video.synthetic_video(3, 20, 30, seed=4)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / f"f{i:03d}.png")
    for crop in ("16_24", "24_40"):  # a crop, and a bicubic upsize
        a = port_video.VideoData.from_dir(str(tmp_path), crop)
        b = ref_video.VideoData.from_dir(str(tmp_path), crop)
        np.testing.assert_array_equal(a.frames, b.frames)


@pytest.mark.parametrize("shape,bits", [((3, 3, 40, 60), 8), ((64, 70), 8),
                                        ((5, 2, 4, 16), 6), ((7,), 8)])
def test_ptq_matches_jax(shape, bits):
    t = np.random.default_rng(len(shape) + bits).normal(
        size=shape).astype(np.float32)
    q, deq = quant_tensor(t, bits)
    rq, rdeq = ref_ptq.quant_tensor(t, bits)
    np.testing.assert_array_equal(deq, rdeq)
    for k in ("quant", "min", "scale"):
        np.testing.assert_array_equal(q[k], rq[k])
        assert np.asarray(q[k]).dtype == np.asarray(rq[k]).dtype
    np.testing.assert_array_equal(dequant_tensor(q),
                                  ref_ptq.dequant_tensor(rq))


@pytest.mark.parametrize("n_symbols", [1, 2, 17, 200])
def test_huffman_lengths_match_jax(n_symbols):
    r = np.random.default_rng(n_symbols)
    counts = {int(s): int(c) for s, c in
              zip(range(n_symbols), r.integers(1, 1000, n_symbols))}
    assert huffman_code_lengths(counts) == \
        ref_huffman.huffman_code_lengths(counts)


def test_logger_files_read_back_as_jax_writes_them(tmp_path):
    cfg = BoostConfig(lr=1e-5, modelsize=2.8, enc_strds=[5, 3],
                      clip_max_norm=None, vid="a: 'b'")
    row = {"Vid": "v", "Time": 1.5, "ENC_strds": "5,3,2", "Batch": 2,
           "bits/pixel": 0.012346, "PSNR_list_10": "20.10,21.30"}
    port = RunLogger(str(tmp_path / "port"), enable_tb=False)
    ref = RefLogger(str(tmp_path / "ref"), enable_tb=False)
    port.dump_config(cfg)
    port.dump_csv(row, "r.csv")
    ref.dump_csv(row, "r.csv")
    with open(tmp_path / "port" / "args.yaml") as f:
        assert yaml.safe_load(f) == dataclasses.asdict(cfg)
    with open(tmp_path / "port" / "r.csv") as f, \
            open(tmp_path / "ref" / "r.csv") as g:
        assert f.read() == g.read()
    port.print("hello")
    with open(os.path.join(tmp_path, "port", "rank0.txt")) as f:
        assert f.read().endswith("] hello\n")
