"""The torch port imports without jax and without the JAX package (and
without yaml, pandas, PIL, imageio and tensorboardX, which the GPU
machine's listing lacks),
its trainers (regression, and CEM compression with its rANS coding eval)
run without them, a checkpoint the JAX package pickled (an optax state in
it) loads without them, and chip_smoke.py refuses to run without a GPU."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "boosting_nerv_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import boosting_nerv_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "boosting_nerv_tpu",
                                       "yaml", "pandas", "PIL", "imageio",
                                       "tensorboardX"))
assert not leaked, leaked
print(len(names))
"""


def test_port_and_every_submodule_import_without_jax():
    # a subprocess: tests/conftest.py has imported jax into this one
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 51  # every module of the slices


_TRAIN_WITHOUT = """
import sys
for name in ("jax", "flax", "boosting_nerv_tpu", "yaml", "pandas", "PIL",
             "tensorboardX"):
    sys.modules[name] = None  # importing it raises ImportError
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.training.trainer import RegressionTrainer
cfg = BoostConfig(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_hw="2_4", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 1], conv_type=["convnext", "pshuffel_3x3"],
    act="sin", sft_block="res_sft", ch_t=8, lower_width=4, enc_strds=[2, 2],
    enc_dim="8_4", epochs=1, batchSize=2, loss="L1_freq",
    outf=sys.argv[1])
t = RegressionTrainer(cfg, video=VideoData(synthetic_video(4, 8, 16)),
                      device="cpu")
t.train()
print(t.fps > 0 and t.bits_per_param > 0)
"""


def test_training_path_needs_no_yaml_pandas_pil_or_tensorboard(tmp_path):
    # the GPU machine has none of them: the trainer with its default
    # logger (TensorBoard on), train, eval, PTQ, Huffman and checkpoints
    res = subprocess.run([sys.executable, "-c", _TRAIN_WITHOUT,
                          str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "True"


_BLOCK = """
import sys
for name in ("jax", "flax", "boosting_nerv_tpu", "yaml", "pandas", "PIL",
             "tensorboardX", "optax"):
    sys.modules[name] = None  # importing it raises ImportError
"""
_CEM_WITHOUT = _BLOCK + """
import torch
torch.set_num_threads(1)  # tiny work; the suite runs several workers
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.training import checkpoint
from boosting_nerv_torch.training.compress_trainer import CompressionTrainer
ck = checkpoint.load_checkpoint(sys.argv[2])  # pickled by the JAX package
assert type(ck["opt_state"][1]).__name__ == "ForeignState", ck["opt_state"]
assert int(ck["opt_state"][1][0]) == 3 and ck["params"]["qp"]["k"]["scale"]
cfg = BoostConfig(
    model="NeRV_Boost", embed="pe_1.25_20", fc_hw="2_4", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 1], conv_type=["convnext", "pshuffel_3x3"],
    act="sin", sft_block="res_sft", ch_t=8, lower_width=4, epochs=1,
    batchSize=2, loss="L2", quant=True, quantizer_w="scale",
    quantizer_b="scale", outf=sys.argv[1])
t = CompressionTrainer(cfg, video=VideoData(synthetic_video(4, 8, 16)),
                       device="cpu")
t.train()
print(t.total_bpp > 0 and t.estimate_bpp > 0 and t.fps > 0)
"""


def test_compression_path_needs_no_jax(tmp_path):
    # a JAX CEM checkpoint's tree, with an Adan state (a NamedTuple of the
    # JAX package) in it, pickled here where the JAX package is importable
    import numpy as np

    from boosting_nerv_tpu.training.adan import AdanState
    from boosting_nerv_tpu.training.checkpoint import save_checkpoint

    zeros = {"k": np.zeros(2, np.float32)}
    path = str(tmp_path / "jax_cem.ckpt")
    save_checkpoint(path, 1, {"model": {}, "qp": {"k": {"scale": np.ones(
        1, np.float32)}}}, ((), AdanState(np.int32(3), zeros, zeros, zeros,
                                          zeros)))
    res = subprocess.run([sys.executable, "-c", _CEM_WITHOUT,
                          str(tmp_path / "run"), path], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "True"


def test_port_sources_name_no_jax():
    # nor imageio, nor the repo-root JAX CLIs, tools/ or scripts/
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|boosting_nerv_tpu|imageio|"
        r"train_nerv_all|train_nerv_compression|tools|scripts)\b", re.M)
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "build"]  # compiled kernels
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f


def test_chip_smoke_fails_without_cuda():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no CUDA device" in res.stderr
