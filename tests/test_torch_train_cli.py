"""The port's CLI, ``python -m boosting_nerv_torch.train_nerv_all``: the
JAX CLI's flags with the same defaults, plus ``--device``; ``--sp``
above 1 (the last flag that raised) and the task flags are accepted; a
tiny run on a directory of PNG frames on the CPU."""

import os

import pytest
import torch
from PIL import Image

import train_nerv_all as ref_cli
from boosting_nerv_torch import train_nerv_all as port_cli
from boosting_nerv_torch.data import synthetic_video

TINY_FLAGS = [
    "--model", "HNeRV_Boost", "--embed", "pe_1.25_20", "--fc_hw", "2_4",
    "--fc_dim", "12", "--dec_strds", "2", "2", "--dec_blks", "1", "1",
    "--ks", "0_1_5", "--conv_type", "convnext", "pshuffel_3x3",
    "--act", "sin", "--sft_block", "res_sft", "--ch_t", "8",
    "--lower_width", "4", "--enc_strds", "2", "2", "--enc_dim", "8_4",
    "--crop_list", "8_16", "--loss", "L1_freq", "-b", "2", "--lr", "0.005",
    "--device", "cpu"]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_every_jax_flag_exists_with_its_default():
    ref, port = _actions(ref_cli.build_parser()), \
        _actions(port_cli.build_parser())
    assert set(port) - set(ref) == {"device"}
    assert port["device"].default == "cuda"
    for dest, a in ref.items():
        assert port[dest].option_strings == a.option_strings, dest
        assert port[dest].default == a.default, dest
        assert port[dest].nargs == a.nargs, dest


@pytest.mark.parametrize("flags,item", [
    # -d, --dp and --sp are ported (tests/test_torch_parallel_cli.py,
    # tests/test_torch_spatial_cem.py): the flags that raised until then
    # now parse into the mesh they ask for
    (["-d", "--sp", "2"], "spatial"),
    (["--sp", "2"], "spatial"),
])
def test_not_ported_flags_raise(tmp_path, monkeypatch, flags, item):
    monkeypatch.chdir(tmp_path)
    args = port_cli.build_parser().parse_args(
        TINY_FLAGS + ["--data_path", "x"] + flags)
    cfg = port_cli.args_to_config(args)
    assert (cfg.dp, cfg.sp) == (1, 2)  # -d on the CPU is one data rank
    assert port_cli.mesh_args(cfg, "cpu") == dict(
        dp=1, sp=2, devices=[torch.device("cpu")] * 2)


@pytest.mark.parametrize("flags,field,value", [
    (["--interpolation"], "interpolation", True),
    (["--eval_only"], "eval_only", True),
    (["--dump_images"], "dump_images", True),
    (["--planar_train", "180"], "planar_train", 180),
])
def test_task_flags_are_accepted(tmp_path, monkeypatch, flags, field, value):
    # refused until the tasks slice ported them
    monkeypatch.chdir(tmp_path)
    args = port_cli.build_parser().parse_args(
        TINY_FLAGS + ["--data_path", "x"] + flags)
    cfg = port_cli.args_to_config(args)
    assert getattr(cfg, field) == value


def test_tiny_run_on_png_frames(tmp_path, monkeypatch):
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(synthetic_video(4, 12, 20, seed=1)):
        Image.fromarray(f).save(frames_dir / f"{i:04d}.png")  # cropped to 8x16
    monkeypatch.chdir(tmp_path)
    best = port_cli.main(TINY_FLAGS + [
        "--data_path", str(frames_dir), "--vid", "syn", "--outf", "tiny",
        "-e", "2", "--eval_freq", "1"])
    outf = os.path.join("output", "tiny", "syn", "Size1.5")
    assert {"args.yaml", "epoch2.csv", "model_latest.ckpt",
            "rank0.txt"} <= set(os.listdir(outf))
    assert best["pred_seen_psnr"] > 0
