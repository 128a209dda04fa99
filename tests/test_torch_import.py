"""The torch port imports without jax and without the JAX package, and
chip_smoke.py refuses to run without a GPU."""

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
                if m.split(".")[0] in ("jax", "flax", "boosting_nerv_tpu"))
assert not leaked, leaked
print(len(names))
"""


def test_port_and_every_submodule_import_without_jax():
    # a subprocess: tests/conftest.py has imported jax into this one
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15  # every module of the slice


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
