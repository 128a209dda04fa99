"""The port's compression CLI, ``python -m
boosting_nerv_torch.train_nerv_compression``, on the CPU: the port CLI's
flags plus the ten compression flags with the JAX defaults; a tiny CEM
finetune of HNeRV-Boost on PNG frames, then ``--eval_only`` on its
checkpoint; and ``BNT_CEM_EVAL_LAST_ONLY``, on only when set to anything
but "" or "0"."""

import os

import pytest
from PIL import Image

from boosting_nerv_torch import train_nerv_all as port_cli
from boosting_nerv_torch import train_nerv_compression as cli
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.data import synthetic_video
from boosting_nerv_torch.training import compress_trainer
from test_torch_compress_trainer import one_torch_thread  # noqa: F401

COMPRESSION_FLAGS = ("quant_bias_bit", "per_channel_w", "per_channel_b",
                     "per_channel_e", "quantizer_w", "quantizer_b",
                     "quantizer_e", "embed_entropy", "target_bit",
                     "lambda_rate")
TINY_FLAGS = [
    "--model", "HNeRV_Boost", "--embed", "pe_1.25_20", "--fc_hw", "2_4",
    "--fc_dim", "12", "--dec_strds", "2", "2", "--dec_blks", "1", "1",
    "--ks", "0_1_5", "--conv_type", "convnext", "pshuffel_3x3",
    "--act", "sin", "--sft_block", "res_sft", "--ch_t", "8",
    "--lower_width", "4", "--enc_strds", "2", "2", "--enc_dim", "8_4",
    "--crop_list", "8_16", "--loss", "L2", "-b", "2", "--lr", "0.0005",
    "--lr_type", "cosine_0_1_0.1", "--quant_embed_bit", "8",
    "--quantizer_w", "scale", "--quantizer_b", "scale",
    "--quantizer_e", "scalebeta", "--embed_entropy", "--lambda_rate",
    "0.05", "--target_bit", "4", "--device", "cpu", "--vid", "syn",
    "--outf", "tiny"]
OUTF = os.path.join("output", "tiny", "syn", "Size1.5")


def test_flags_are_the_port_clis_plus_the_compression_flags():
    port = {a.dest: a for a in port_cli.build_parser()._actions}
    comp = {a.dest: a for a in cli.build_compression_parser()._actions}
    assert set(comp) - set(port) == set(COMPRESSION_FLAGS)
    default = BoostConfig()
    for name in COMPRESSION_FLAGS:
        assert comp[name].default == getattr(default, name), name
        assert comp[name].option_strings == [f"--{name}"]


@pytest.fixture
def frames_dir(tmp_path, monkeypatch):
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(synthetic_video(4, 12, 20, seed=1)):
        Image.fromarray(f).save(d / f"{i:04d}.png")  # cropped to 8x16
    monkeypatch.chdir(tmp_path)
    return str(d)


def test_tiny_finetune_then_eval_only(frames_dir):
    best = cli.main(TINY_FLAGS + ["--data_path", frames_dir, "-e", "1",
                                  "--not_resume"])
    assert {"args.yaml", "epoch1.csv", "model_latest.ckpt",
            "model_best.ckpt", "epoch1.ckpt"} <= set(os.listdir(OUTF))
    assert best["quant_seen_psnr"] > 0 and best["pred_seen_psnr"] == 0
    again = cli.main(TINY_FLAGS + ["--data_path", frames_dir, "-e", "1",
                                   "--eval_only"])
    assert again["quant_seen_psnr"] == pytest.approx(
        best["quant_seen_psnr"], abs=1e-9)
    assert {"eval.csv", "eval.txt"} <= set(os.listdir(OUTF))
    with open(os.path.join(OUTF, "eval.txt")) as f:
        assert "best_quant_seen_psnr" in f.read()


@pytest.mark.parametrize("value,on", [(None, False), ("", False),
                                      ("0", False), ("1", True),
                                      ("yes", True)])
def test_eval_last_only_is_on_only_when_set_and_not_0(monkeypatch, value,
                                                      on):
    if value is None:
        monkeypatch.delenv("BNT_CEM_EVAL_LAST_ONLY", raising=False)
    else:
        monkeypatch.setenv("BNT_CEM_EVAL_LAST_ONLY", value)
    assert compress_trainer.eval_last_only() is on


@pytest.mark.parametrize("value,evals", [("0", 2), ("1", 1)])
def test_eval_last_only_in_a_run(frames_dir, monkeypatch, value, evals):
    """Which evals a 2-epoch run makes (each eval recorded, not run)."""
    monkeypatch.setenv("BNT_CEM_EVAL_LAST_ONLY", value)
    seen = []

    def record(self, coding=False):
        seen.append(coding)
        return dict.fromkeys(compress_trainer.METRIC_NAMES, 1.0)

    monkeypatch.setattr(compress_trainer.CompressionTrainer,
                        "evaluate_cem", record)
    cli.main(TINY_FLAGS + ["--data_path", frames_dir, "-e", "2",
                           "--eval_freq", "1", "--not_resume"])
    assert seen == [False, True][-evals:]
