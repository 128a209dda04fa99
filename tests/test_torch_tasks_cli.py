"""The port's script surface on the CPU: a tiny interpolation run of the
CLI with ``--profile --dump_images --dump_videos``, then ``--eval_only``
on its checkpoint; the PNG and dump path with Pillow blocked; and every
command of the 20 recipes under ``scripts/``, listed by
``boosting_nerv_torch.recipes``, giving the JAX CLIs' config and accepted
by the port."""

import csv
import dataclasses
import glob
import json
import os
import subprocess
import sys

import pytest
import torch
from PIL import Image

import train_nerv_all as ref_cli
import train_nerv_compression as ref_comp_cli
from boosting_nerv_torch import recipes
from boosting_nerv_torch import train_nerv_all as port_cli
from boosting_nerv_torch import train_nerv_compression as port_comp_cli
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.data import synthetic_video
from boosting_nerv_torch.data.png import write_png
from boosting_nerv_torch.ops.quantize import get_quantizer
from boosting_nerv_torch.training.trainer import METRIC_NAMES
from boosting_nerv_tpu.config import BoostConfig as RefBoostConfig
from boosting_nerv_tpu.training import compress_trainer as ref_ct
from test_torch_train_cli import TINY_FLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "scripts", "**", "*.sh"), recursive=True))
TASK_FLAGS = ["--interpolation", "--embed_inter", "--data_split", "1_1_2",
              "-b", "1", "--vid", "syn"]
N_FRAMES = 15  # 8 training frames: 8 steps an epoch, so steps 2-6 trace
EVAL_TOL = 1e-5
JAX_ONLY = {"decode_dtype"}  # the JAX serving decode's dtype switch
PORT_ONLY = set()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU work on one thread: the suite runs several
    workers, and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_clip(path, n=N_FRAMES):
    os.makedirs(path, exist_ok=True)
    frames = synthetic_video(n, 12, 20, seed=1)
    for i, f in enumerate(frames):
        write_png(os.path.join(path, f"{i:04d}.png"), f)  # cropped to 8x16
    return frames


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 2-epoch interpolation run with the profiler and both dumps; its
    argv (an absolute ``--outf``), trainer and output directory."""
    root = tmp_path_factory.mktemp("tasks")
    _write_clip(str(root / "frames"))
    argv = TINY_FLAGS + TASK_FLAGS + ["--data_path", str(root / "frames"),
                                      "--outf", str(root / "run"), "-e", "2",
                                      "--eval_freq", "1"]
    tr = port_cli.run(argv + ["--not_resume", "--profile", "--dump_images",
                              "--dump_videos"])
    return argv, tr, tr.cfg.outf


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_eval_only_reproduces_the_last_eval(run):
    argv, tr, outf = run
    ev = port_cli.run(argv + ["--eval_only"])  # auto-resumes the run
    for k in METRIC_NAMES:
        assert abs(ev.last_eval[k] - tr.last_eval[k]) <= EVAL_TOL, k
        assert ev.best_metrics[k] == ev.last_eval[k]
    header, row = _csv(os.path.join(outf, "eval.csv"))
    assert header == _csv(os.path.join(outf, "epoch2.csv"))[0]
    got = dict(zip(header, row))
    assert (got["CurEpoch"], got["Time"]) == ("2", "0.0")
    with open(os.path.join(outf, "eval.txt")) as f:
        lines = [x for x in f.read().splitlines() if x]
    assert len(lines) == 1 and lines[0].startswith("best_pred_seen_psnr: ")


def test_last_eval_dumps_every_frame_and_the_gif(run):
    _, tr, outf = run
    names = sorted(os.listdir(os.path.join(outf, "visualize_model_orig")))
    assert [n[:10] for n in names] == [f"pred_{i:04d}_" for i in
                                       range(tr.video.n)]
    assert all(n.endswith(".png") and float(n[10:-4]) > 0 for n in names)
    with Image.open(os.path.join(outf, "gt_pred.gif")) as im:
        assert (im.n_frames, im.size) == (tr.video.n, (16, 8))
    assert (tr.video.n, tr.train_ind) == (N_FRAMES, list(range(0, 15, 2)))


def test_profile_traces_steps_2_to_6(run):
    _, tr, outf = run
    with open(os.path.join(outf, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events
             if e.get("ph") == "X" and e.get("name", "").startswith("train.")]
    assert names.count("train.step") == 5  # steps 2-6
    assert {"train.gather", "train.forward", "train.loss", "train.backward",
            "train.psnr", "train.optim"} <= set(names)
    with open(tr.logger.log_path) as f:
        log = f.read()
    assert "spans over 5 unit(s)" in log and "train.backward" in log


_BLOCKED = """
import sys
for name in ("PIL", "imageio"):
    sys.modules[name] = None  # importing it raises ImportError
import torch
torch.set_num_threads(1)
from boosting_nerv_torch import train_nerv_all
tr = train_nerv_all.run(sys.argv[1:])
print(tr.video.n, sorted(tr.last_eval) == sorted(tr.best_metrics))
"""


def test_png_and_dump_path_runs_with_pillow_blocked(tmp_path):
    _write_clip(str(tmp_path / "frames"), 5)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED] + TINY_FLAGS + TASK_FLAGS + [
            "--data_path", str(tmp_path / "frames"), "--outf",
            str(tmp_path / "run"), "-e", "1", "--dump_images",
            "--dump_videos"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "5 True"
    outf = tmp_path / "run" / "syn" / "Size1.5"
    assert len(os.listdir(outf / "visualize_model_orig")) == 5
    with Image.open(outf / "gt_pred.gif") as im:
        assert im.n_frames == 5


def test_recipe_runner_runs_a_recipe_on_the_port(tmp_path):
    # a recipe in the scripts' form: the regression CLI through the shim,
    # the extra flags appended, anything else to the real interpreter
    _write_clip(str(tmp_path / "frames"), 4)
    flags = " ".join(TINY_FLAGS[:-2] + ["--vid", "syn", "-e", "1"])
    (tmp_path / "r.sh").write_text(
        "#!/bin/sh\n"
        f"python train_nerv_all.py {flags} --data_path ./frames "
        "--outf recipe\n"
        "python -c 'print(\"real interpreter\")'\n")
    res = subprocess.run(
        [sys.executable, "-m", "boosting_nerv_torch.recipes", "r.sh", "--",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO,
                          "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "real interpreter"
    assert (tmp_path / "output" / "recipe" / "syn" / "Size1.5" /
            "epoch1.csv").is_file()
    dry = recipes.recipe_commands(str(tmp_path / "r.sh"), ["--x"])
    assert dry == [("boosting_nerv_torch.train_nerv_all",
                    flags.split() + ["--data_path", "./frames", "--outf",
                                     "recipe", "--x"])]


class _Captured(Exception):
    pass


def _jax_compression_config(argv, monkeypatch):
    """The config the JAX compression CLI's ``main()`` builds from
    ``argv``, captured where it would build its trainer."""
    seen = []

    def record(cfg):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(ref_ct, "CompressionTrainer", record)
    monkeypatch.setattr(sys, "argv", ["train_nerv_compression.py", *argv])
    with pytest.raises(_Captured):
        ref_comp_cli.main()
    return seen[0]


def test_config_fields_of_the_two_packages():
    port = {f.name for f in dataclasses.fields(BoostConfig)}
    ref = {f.name for f in dataclasses.fields(RefBoostConfig)}
    assert (ref - port, port - ref) == (JAX_ONLY, PORT_ONLY)


@pytest.mark.parametrize("recipe,env", [(r, {}) for r in RECIPES] + [
    ("scripts/regression/bunny/hnerv_boost.sh", {"BNT_FAST": "1"})])
def test_every_recipe_command_gives_the_jax_config(recipe, env, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)  # both CLIs create output/...
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cmds = recipes.recipe_commands(os.path.join(REPO, recipe))
    assert len(cmds) >= 3
    common = [f.name for f in dataclasses.fields(BoostConfig)]
    for cli, argv in cmds:
        if cli == "boosting_nerv_torch.train_nerv_all":
            want = ref_cli.args_to_config(ref_cli.build_parser().parse_args(
                argv))
            got = port_cli.args_to_config(port_cli.build_parser().parse_args(
                argv))
        else:
            assert cli == "boosting_nerv_torch.train_nerv_compression"
            want = _jax_compression_config(argv, monkeypatch)
            got = port_comp_cli.compression_config(
                port_comp_cli.build_compression_parser().parse_args(argv))
        for name in common:
            assert getattr(got, name) == getattr(want, name), (argv, name)
        for q in (got.quantizer_w, got.quantizer_b, got.quantizer_e):
            get_quantizer(q)
    if env:  # BNT_FAST's branch: b=2 with the planar training forward
        assert all("--planar_train" in argv for _, argv in cmds)
        assert (got.batchSize, got.planar_train) == (2, 180)
