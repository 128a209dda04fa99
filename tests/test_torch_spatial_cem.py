"""The port's CEM step split by rows (the mesh's 'spatial' axis) against
the JAX package's unsharded step, and ``--sp 2`` through both CLIs, on
gloo CPU ranks.

- tests/test_torch_compress_trainer.py's HNeRV-Boost with
  ``embed_entropy`` (8x16 frames, batch 2, scale / scale / scalebeta at 8
  bits, lambda 0.05, target_bit 4, Adan, lr 5e-4) from the JAX trainer's
  bridged init and quantisers: one CEM step of the port at dp x sp =
  1 x 2, fed the JAX step's noise, against the JAX trainer's 1 x 1
  ``cem_step``, at that file's tolerances (loss and bpp rtol 1e-4; the
  parameters and quantiser parameters rtol 1e-4 and atol 1e-4 of the
  leaf's largest, or within a flipped step, 2 lr (1 + 1e-3), where the
  gradient is below 1e-6 of the step's largest).  At sp 2 the frame and
  the decoder's last stage are split; the embedding's Gaussian is summed
  over no rank (the data group is one rank), where a sum over the
  spatial group would count the whole embedding twice.
- ``--sp 2 --device cpu`` through ``train_nerv_all`` (one step of a
  global batch 2 on 8x16 PNG frames and its eval, whose fps clock runs
  the split decode on both ranks) and ``train_nerv_compression`` (one CEM
  step and its coding eval): one set of outputs, the split plan in rank
  0's log, and parameters within rtol 1e-4 and atol 1e-6 of the
  ``--sp 1`` run's.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from boosting_nerv_torch import train_nerv_all as port_cli
from boosting_nerv_torch import train_nerv_compression as comp_cli
from boosting_nerv_torch.bridge import (flax_params_from_torch_state,
                                        torch_state_from_flax)
from boosting_nerv_torch.data import png, synthetic_video
from boosting_nerv_torch.parallel import launch
from boosting_nerv_torch.parallel.steps import cem_steps
from boosting_nerv_torch.training.checkpoint import load_checkpoint
from test_torch_compress_cli import TINY_FLAGS as COMP_FLAGS
from test_torch_compress_trainer import (LR, MODELS, STATE_TOL, STEP_RTOL,
                                         TINY_GRAD, build_ref, frames,
                                         run_jax_step)
from test_torch_parallel_dp import port_cfg
from test_torch_train_cli import TINY_FLAGS

PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
TIMEOUT = 120.0  # seconds a rank waits in a collective
IDX = [0, 1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cem(tmp_path_factory):
    """(JAX's step: state, loss, bpp; the port's 1 x 2 rank results)."""
    ref = build_ref(tmp_path_factory, "HNeRV_Boost", **MODELS["HNeRV_Boost"])
    pcfg = port_cfg(ref.cfg0, outf=str(tmp_path_factory.mktemp("port")))
    init = {k: v.numpy() for k, v in torch_state_from_flax(
        jax.device_get(ref.params), pcfg).items()}
    state, _, loss, bpp, noise = run_jax_step(ref)
    got = launch(cem_steps, dict(dp=1, sp=2, devices=["cpu"] * 2),
                 args=(pcfg.replace(sp=2), frames(), init, IDX, LR,
                       {k: v.numpy() for k, v in noise.items()}),
                 timeout=TIMEOUT)
    return state, loss, bpp, pcfg, got


def _close(name, got, want, grad, flip):
    atol = STATE_TOL * np.abs(want).max()
    err = np.abs(got - want)
    bad = err > atol + STATE_TOL * np.abs(want)
    bad &= ~((np.abs(grad) <= flip) & (err <= 2 * LR * (1 + 1e-3)))
    assert not bad.any(), (name, got[bad], want[bad])


def test_cem_step_sp2_matches_jax_1x1(cem):
    state, want_loss, want_bpp, pcfg, ranks = cem
    got = ranks[0]
    assert ranks[1]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"][0], want_loss, rtol=STEP_RTOL)
    np.testing.assert_allclose(got["bpps"][0], want_bpp, rtol=STEP_RTOL)
    assert got["split_plan"][0] == "frame 8: split (rows taken)"
    assert "upconv 8: split (rows taken)" in got["split_plan"]
    grads = got["grads"][0]
    flip = TINY_GRAD * max(
        [float(np.abs(g).max()) for g in grads.values()]
        + [float(np.abs(g).max()) for d in got["qp_grads"].values()
           for g in d.values()]
        + [float(np.abs(g).max()) for g in got["embed_qp_grads"].values()])
    params = flatten_dict(flax_params_from_torch_state(
        {k: torch.from_numpy(v) for k, v in got["states"][0].items()},
        pcfg))
    pgrads = flatten_dict(flax_params_from_torch_state(
        {k: torch.from_numpy(v) for k, v in grads.items()}, pcfg))
    want = flatten_dict(jax.device_get(state["model"]))
    assert sorted(params) == sorted(want)
    for k, w in want.items():
        _close("/".join(k), params[k], np.asarray(w), pgrads[k], flip)
    for key, d in jax.device_get(state["qp"]).items():
        for n, w in d.items():
            _close(f"{key}/{n}", got["qp"][key][n], np.asarray(w),
                   got["qp_grads"][key][n], flip)
    for n, w in jax.device_get(state["embed_qp"]).items():
        _close(f"embed_qp/{n}", got["embed_qp"][n], np.asarray(w),
               got["embed_qp_grads"][n], flip)


@pytest.fixture
def frames_dir(tmp_path, monkeypatch):
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(synthetic_video(2, 12, 20, seed=3)):
        png.write_png(str(d / f"{i:04d}.png"), f)  # cropped to 8x16
    monkeypatch.chdir(tmp_path)
    return str(d)


def _same_params(path_a, path_b):
    a, b = (flatten_dict(load_checkpoint(os.path.join(p, "model_latest.ckpt"))
                         ["params"]) for p in (path_a, path_b))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg="/".join(k))


@pytest.mark.parametrize("which", ["regression", "compression"])
def test_sp2_through_the_cli(frames_dir, which):
    cli, flags = ((port_cli, TINY_FLAGS + ["--vid", "syn"])
                  if which == "regression" else (comp_cli, COMP_FLAGS))
    paths = {}
    for sp in (1, 2):
        outf = f"{which}_sp{sp}"
        best = cli.main(flags + ["--data_path", frames_dir, "-e", "1",
                                 "--outf", outf, "--sp", str(sp),
                                 "--not_resume"])
        paths[sp] = os.path.join("output", outf, "syn", "Size1.5")
        key = "pred_seen_psnr" if which == "regression" else \
            "quant_seen_psnr"
        assert best[key] > 0
    assert sorted(os.listdir(paths[2])) == sorted(os.listdir(paths[1]))
    with open(os.path.join(paths[2], "rank0.txt")) as f:
        log = f.read()
    assert "sp 2" in log and "split plan (rank 0, mesh 1x2)" in log
    assert "Eval FPS" in log
    _same_params(paths[2], paths[1])
