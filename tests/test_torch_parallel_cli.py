"""The port's CLIs data-parallel on the CPU: ``--dp 2 --device cpu``
starts two gloo ranks itself.  On 8 PNG frames written by ``data/png.py``,
one epoch of the regression CLI (4 steps of a global batch 2) leaves one
set of outputs (rank 0's log, CSV and checkpoint) whose parameters equal
the ``--dp 1`` run's within rtol 1e-4 and atol 1e-6; the compression CLI
hands the same launch its rank function and plan (the CEM step at dp > 1
is held to dp=1 by tests/test_torch_parallel_cem.py); ``-d`` on the CPU
is one rank, as JAX's ``-d`` on one CPU device; ``--sp`` above 1 launches
dp x sp ranks (tests/test_torch_spatial_cem.py runs them), and a mesh
with more ranks than devices still raises."""

import os

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from boosting_nerv_torch import train_nerv_all as port_cli
from boosting_nerv_torch import train_nerv_compression as comp_cli
from boosting_nerv_torch.data import png, synthetic_video
from boosting_nerv_torch.parallel.mesh import resolve
from boosting_nerv_torch.training.checkpoint import load_checkpoint
from test_torch_compress_cli import TINY_FLAGS as COMP_FLAGS
from test_torch_train_cli import TINY_FLAGS

PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def frames_dir(tmp_path, monkeypatch):
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(synthetic_video(8, 12, 20, seed=2)):
        png.write_png(str(d / f"{i:04d}.png"), f)  # cropped to 8x16
    monkeypatch.chdir(tmp_path)
    return str(d)


def _outputs(outf):
    path = os.path.join("output", outf, "syn", "Size1.5")
    return path, sorted(os.listdir(path))


def _assert_same_tree(got, want):
    got, want = flatten_dict(got), flatten_dict(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg="/".join(k))


def test_dp2_trains_as_dp1_with_one_set_of_outputs(frames_dir):
    common = ["--data_path", frames_dir, "--vid", "syn", "-e", "1"]
    runs = {}
    for dp in (1, 2):
        best = port_cli.main(TINY_FLAGS + common + [
            "--outf", f"dp{dp}", "--dp", str(dp)])
        path, files = _outputs(f"dp{dp}")
        with open(os.path.join(path, "rank0.txt")) as f:
            log = f.read().splitlines()
        runs[dp] = best, path, files, log
    (best_1, path_1, files_1, log_1), (best_2, path_2, files_2, log_2) = (
        runs[1], runs[2])
    assert files_2 == files_1
    assert {"epoch1.csv", "model_latest.ckpt", "rank0.txt"} <= set(files_2)
    assert len(log_2) == len(log_1)  # rank 1 writes no log
    assert sum("Eval at epoch 1" in line for line in log_2) == 1
    assert "dp 2" in log_2[0]
    np.testing.assert_allclose(best_2["pred_seen_psnr"],
                               best_1["pred_seen_psnr"], rtol=1e-4)
    ck_1, ck_2 = (load_checkpoint(os.path.join(p, "model_latest.ckpt"))
                  for p in (path_1, path_2))
    assert ck_2["epoch"] == ck_1["epoch"] == 1
    _assert_same_tree(ck_2["params"], ck_1["params"])


def test_compression_cli_launches_its_ranks(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(comp_cli, "launch", lambda fn, plan_args, args:
                        calls.append((fn, plan_args, args)) or [{"ok": 1}])
    got = comp_cli.main(COMP_FLAGS + ["--data_path", "x", "--dp", "2"])
    (fn, plan_args, (cfg, device)), = calls
    assert got == {"ok": 1} and fn is comp_cli._rank_run
    assert plan_args == dict(dp=2, sp=1, devices=[torch.device("cpu")] * 2)
    assert (cfg.dp, cfg.quant, device) == (2, True, "cpu")


def test_d_on_the_cpu_is_one_rank(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = port_cli.build_parser().parse_args(
        TINY_FLAGS + ["--data_path", "x", "-d"])
    assert port_cli.args_to_config(args).dp == 1
    args = port_cli.build_parser().parse_args(
        TINY_FLAGS + ["--data_path", "x", "-d", "--dp", "3"])
    assert port_cli.args_to_config(args).dp == 3


def test_sp_above_one_still_raises(tmp_path, monkeypatch):
    # the 'spatial' axis is ported: --sp launches dp x sp ranks; what still
    # raises is a mesh with more ranks than devices
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(port_cli, "launch", lambda fn, plan_args, args:
                        calls.append((fn, plan_args, args)) or [{"ok": 1}])
    got = port_cli.main(TINY_FLAGS + ["--data_path", "x", "--dp", "2",
                                      "--sp", "2"])
    (fn, plan_args, (cfg, device)), = calls
    assert got == {"ok": 1} and fn is port_cli._rank_run
    assert plan_args == dict(dp=2, sp=2, devices=[torch.device("cpu")] * 4)
    assert (cfg.dp, cfg.sp, device) == (2, 2, "cpu")
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 2"):
        resolve(**dict(plan_args, devices=[torch.device("cpu")] * 2))
