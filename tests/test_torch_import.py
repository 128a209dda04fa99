"""The torch port imports without jax and without the JAX package (and
without yaml, pandas, PIL and tensorboardX, which the GPU machine lacks),
its trainer runs without them, and chip_smoke.py refuses to run without
a GPU."""

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
                                       "yaml", "pandas", "PIL",
                                       "tensorboardX"))
assert not leaked, leaked
print(len(names))
"""


def test_port_and_every_submodule_import_without_jax():
    # a subprocess: tests/conftest.py has imported jax into this one
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 40  # every module of the slices


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


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|boosting_nerv_tpu)\b", re.M)
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
