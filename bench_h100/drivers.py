"""The general generator: the two kinds of traffic a mix file can name.

``decode``: the serving decode (``build_serving_decode``) of the
configuration's model, batch 1, over the clip's frames; the mix gives the
precision ("bf16" or "w8a8"), the order ("sequential": in order, looped;
"uniform": each request a frame drawn from the seed) and whether each
request is synchronised before the next is sent (a closed loop of one
client) or all are issued back to back.

``train``: ``RegressionTrainer.train_step_idx`` at the configuration's
batch over a permutation of the resident clip drawn from the seed (a new
one each epoch), the learning rate on the recipe's schedule.

Each cell object builds its program state from the seed (``setup``),
runs the window (``window``), frees the program's state (``free``) and
compares what the window produced with the plain reference (``check``):
the family file that ``harness.family`` finds by the configuration's
``model``.
"""

from __future__ import annotations

import gc
import math
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from . import harness, inputs
from .reference import models as ref
from .reference import train as ref_train
from .trace import SPAN


@contextmanager
def fp32_exact():
    """float32 convolutions and matmuls with TF32 off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def mark(cell, label):
    """Note when a step of set-up ended (``cell.marks``)."""
    sync(cell.device)
    cell.marks.append((label, time.perf_counter()))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def frame_times(idx, n: int) -> np.ndarray:
    """The normalised indices (idx + 1) / n, float32, correctly rounded
    on the host as the program's data layer makes them; both sides get
    these same values (the positional encoding's top frequencies turn one
    ulp of t into a different frame)."""
    return (np.asarray(idx, dtype=np.float32) + np.float32(1.0)) / np.float32(n)


def port_config(cfg: dict, **extra):
    """The program's ``BoostConfig`` of a configuration file."""
    from boosting_nerv_torch.config import BoostConfig

    clip = cfg["clip"]
    return BoostConfig(**cfg["model"],
                       crop_list=f"{clip['height']}_{clip['width']}", **extra)


def wrap_spans(module, names):
    """Wrap each function ``names`` of ``module`` in a ``record_function``
    span "bench::<name>" (before a decode is built: it looks them up)."""
    for name in names:
        fn = getattr(module, name)
        if getattr(fn, "bench_span", False):
            continue

        def wrapped(*args, _fn=fn, _span=SPAN + name, **kw):
            with torch.profiler.record_function(_span):
                return _fn(*args, **kw)
        wrapped.bench_span = True
        setattr(module, name, wrapped)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def worst(got: Dict[str, float], want: Dict[str, float], floor: float,
          names=None) -> float:
    """The widest gap |got - want| of a leaf's norm against the larger of
    the reference's norm of that leaf and ``floor`` (the median leaf's)."""
    names = want.keys() if names is None else names
    return max((abs(got.get(k, 0.0) - want[k]) / max(want[k], floor)
                for k in names), default=0.0)


class DecodeCell:
    """A decode mix over one configuration."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda",
                 trace: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.trace = device, trace
        self.n = cfg["clip"]["frames"]
        self.fam = harness.family(cfg["model"]["model"])
        rng = np.random.default_rng([seed, 1])
        self.sample = set(rng.choice(self.n, mix["check_frames"],
                                     replace=False).tolist())
        self.calib_idx = sorted(rng.choice(self.n, mix["calib_frames"],
                                           replace=False).tolist())
        self.order = np.random.default_rng([seed, 2])
        self.kept: Dict[int, torch.Tensor] = {}
        self.latencies: List[float] = []
        self.units = 0
        self.marks: List[tuple] = []

    # -- program -------------------------------------------------------- #
    def setup(self, wrap=None):
        from boosting_nerv_torch.models import build_model
        from boosting_nerv_torch.ops.kernels import planar
        from boosting_nerv_torch.runtime.fast_decode import \
            build_serving_decode

        dev = self.device
        m = self.cfg["model"]
        self.params = inputs.make_weights(m, self.seed, dev)
        self.frame_in = self.fam.frame_inputs(m, self.n, self.seed, dev)
        self.ts = torch.from_numpy(frame_times(np.arange(self.n), self.n)
                                   ).to(dev)[:, None]
        mark(self, "inputs")
        with torch.device(dev):
            model = build_model(port_config(self.cfg), seed=None, device=dev)
        model.load_state_dict(self.params, strict=True)
        if self.trace:
            wrap_spans(planar, planar.WRAPPERS)
        calib = ([self.args(i) for i in self.calib_idx]
                 if self.mix["precision"] == "w8a8" else None)
        self.decode = build_serving_decode(port_config(self.cfg), model,
                                           w8a8_calib=calib)
        self.w8a8_stages = list(getattr(self.decode, "w8a8_stages", []))
        if wrap is not None:
            wrap(self)
        mark(self, "decode built")
        for i in range(self.mix["warm_frames"]):
            self.decode(*self.args(i % self.n))
        mark(self, "warm frames")

    def args(self, i):
        """Frame i's arguments of the decode: its row of the family's frame
        inputs (None without them) and its index."""
        x = self.frame_in
        return (None if x is None else x[i:i + 1]), self.ts[i]

    def next_index(self) -> int:
        if self.mix["order"] == "sequential":
            return self.units % self.n
        return int(self.order.integers(self.n))

    def window(self, seconds: float, max_units: Optional[int] = None):
        """Decode until ``seconds`` have passed (or ``max_units`` frames);
        returns the window's seconds, which end when the last frame is
        done."""
        closed = self.mix["sync_each"]
        clock = time.perf_counter
        sync(self.device)
        t0 = clock()
        while True:
            i = self.next_index()
            start = clock()
            out = self.decode(*self.args(i))
            if closed:
                sync(self.device)
                self.latencies.append(clock() - start)
            if i in self.sample:
                self.kept[i] = out
            self.units += 1
            if clock() - t0 >= seconds or (max_units and
                                           self.units >= max_units):
                break
        sync(self.device)
        return clock() - t0

    def free(self):
        self.decode = None
        _free(self.device)

    # -- reference ------------------------------------------------------ #
    def reference_frames(self, bits: Optional[int] = None,
                         stages: Optional[List[int]] = None,
                         fp8: bool = False):
        """The reference's frames of the kept indices, float32 (TF32 off):
        the configuration's serving precision (its W8A8 stages worked out
        again, on bounds calibrated again from the same frames), or the
        given ``stages`` at ``bits`` (or in fp8), for a control."""
        m = self.cfg["model"]
        plan = self.fam.stage_plan(m)
        if stages is None:
            stages = (ref.w8a8_stages(m, plan)
                      if self.mix["precision"] == "w8a8" else [])
            bits = 8
        p = self.params

        def dec(x, t, quant=None, calib=None):
            return self.fam.decode(x, t, p, m, quant, calib)

        quant = None
        with torch.no_grad(), fp32_exact():
            if stages:
                quant = ref.Quant(tuple(stages), bits, fp8=fp8)
                quant.bounds = ref.calibrate(
                    dec, [self.args(i) for i in self.calib_idx], stages,
                    quant.margin)
            return {i: dec(*self.args(i), quant=quant)
                    for i in sorted(self.kept)}

    def check(self) -> Dict[str, float]:
        """The numbers against the reference's frames (``gaps``), and how
        many frames short of ``check_min_frames`` were kept."""
        want = self.reference_frames()
        return {**self.gaps(self.kept, want),
                "frames_missing": float(max(
                    0, self.mix["check_min_frames"] - len(want)))}

    @staticmethod
    def gaps(got, want) -> Dict[str, float]:
        """The worst frame's RMSE and mean absolute gap, and the widest
        pixel gap, of ``got`` against ``want``, both in the served frames'
        type, bf16: the reference's
        exact frame rounded as the program must store it, so that the
        store's own rounding (up to 2^-9 of a pixel) is no gap."""
        rmse, mae, widest = 0.0, 0.0, 0.0
        for i, w in want.items():
            d = (got[i].to(torch.bfloat16).float()
                 - w.to(torch.bfloat16).float())
            rmse = max(rmse, float(d.pow(2).mean().sqrt()))
            mae = max(mae, float(d.abs().mean()))
            widest = max(widest, float(d.abs().max()))
        return {"frame_rmse": rmse, "frame_mae": mae, "pixel_gap": widest}

    def plan_agrees(self) -> bool:
        """The program serves int8 exactly where the reference's rule
        says."""
        m = self.cfg["model"]
        want = (ref.w8a8_stages(m, self.fam.stage_plan(m))
                if self.mix["precision"] == "w8a8" else [])
        return self.w8a8_stages == want


class TrainCell:
    """A training mix over one configuration."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda",
                 trace: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.trace = device, trace
        self.n = cfg["clip"]["frames"]
        self.batch = cfg["train"]["batch"]
        t = cfg["train"]
        lacks = [f"{key} {got!r}" for key, got, want in (
            ("loss", t["loss"], "Fusion10_freq"),
            ("optim_type", t["optim_type"], "Adan"),
            ("lr_type", t["lr_type"].split("_")[0], "cosine")) if got != want]
        if lacks:
            raise ValueError("the reference trainer lacks " + ", ".join(lacks)
                             + ": it trains with Fusion10_freq, Adan and a "
                             "cosine schedule only")
        self.fam = harness.family(cfg["model"]["model"])
        if not hasattr(self.fam, "forward"):
            raise ValueError(f"the reference family {self.fam.__name__} has "
                             "no training forward")
        self.step_no = 0
        self.units = 0
        self.marks: List[tuple] = []
        self._order: List[int] = []

    def frames_of(self, step: int) -> List[int]:
        """Frame indices of global step ``step``: epoch e's permutation is
        drawn from (seed, e)."""
        per = self.n // self.batch
        e, k = divmod(step, per)
        perm = np.random.default_rng([self.seed, 3, e]).permutation(self.n)
        return perm[k * self.batch:(k + 1) * self.batch].tolist()

    def lr_of(self, step: int) -> float:
        """The recipe's schedule (cosine_<up>_<pow>_<min>): a warm-up from
        min to 1 over the first ``up`` of training, then cosine to 0."""
        t = self.cfg["train"]
        per = self.n // self.batch
        e, k = divmod(step, per)
        progress = (e + k / per) / t["epochs"]
        up, pw, lo = (float(v) for v in t["lr_type"].split("_")[1:])
        if progress < up:
            mult = lo + (1.0 - lo) * (progress / up) ** pw
        else:
            mult = 0.5 * (math.cos(math.pi * (progress - up) / (1 - up)) + 1)
        return t["lr"] * mult

    def setup(self, wrap=None):
        from boosting_nerv_torch.data.video import VideoData
        from boosting_nerv_torch.training.trainer import RegressionTrainer
        from boosting_nerv_torch.utils.logger import NullLogger

        dev, t, clip = self.device, self.cfg["train"], self.cfg["clip"]
        self.params = inputs.make_weights(self.cfg["model"], self.seed, dev)
        self.clip = inputs.make_clip(self.n, clip["height"], clip["width"],
                                     self.seed, dev)
        mark(self, "inputs")
        cfg = port_config(self.cfg, batchSize=self.batch, lr=t["lr"],
                          lr_type=t["lr_type"], epochs=t["epochs"],
                          loss=t["loss"], optim_type=t["optim_type"],
                          train_precision=t["train_precision"],
                          not_resume=True)
        video = VideoData(self.clip.cpu().numpy())
        mark(self, "clip on the host")
        self.trainer = RegressionTrainer(cfg, video=video,
                                         logger=NullLogger(), device=dev)
        tr = self.trainer
        tr.model.load_state_dict(self.params, strict=True)
        mark(self, "trainer built")
        if wrap is not None:
            wrap(self)
        names = dict((id(p), n) for n, p in tr.model.named_parameters())
        # the first steps: the reference follows them
        self.losses = []
        for k in range(self.mix["checked_steps"]):
            loss, _ = self.step()
            self.losses.append(loss)
            if k == 0:
                self.grad_norms = {
                    names[id(p)]: st["prev_grad"].norm()
                    for p, st in tr.opt.state.items() if "prev_grad" in st}
        self.change_norms = {
            n: (p.detach() - self.params[n]).norm()
            for n, p in tr.model.named_parameters()}
        self.losses = [float(v) for v in self.losses]
        self.grad_norms = {k: float(v) for k, v in self.grad_norms.items()}
        self.change_norms = {k: float(v)
                             for k, v in self.change_norms.items()}
        mark(self, "checked steps")
        for _ in range(self.mix["warm_steps"]):
            self.step()
        mark(self, "warm steps")

    def step(self):
        idx = self.frames_of(self.step_no)
        t = frame_times(idx, self.n)
        span = (torch.profiler.record_function(SPAN + "train_step")
                if self.trace else nullcontext())
        with span:
            out = self.trainer.train_step_idx(idx, t,
                                              self.lr_of(self.step_no))
        self.step_no += 1
        return out

    def window(self, seconds: float, max_units: Optional[int] = None):
        clock = time.perf_counter
        sync(self.device)
        t0 = clock()
        while True:
            self.step()
            self.units += self.batch
            if clock() - t0 >= seconds or (
                    max_units and self.units >= max_units * self.batch):
                break
        sync(self.device)
        return clock() - t0

    def free(self):
        self.trainer = None
        _free(self.device)

    def reference_steps(self, autocast_dtype=None):
        """(losses, first-step gradient norms, change norms after the
        checked steps) of the reference on the same weights, frames and
        learning rates: float32 with TF32 off, or under autocast to
        ``autocast_dtype`` (a control)."""
        m = self.cfg["model"]
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in self.params.items()}
        opt = ref_train.Adan(p)
        losses, grads = [], {}
        dev_type = torch.device(self.device).type
        cast = (torch.autocast(dev_type, dtype=autocast_dtype)
                if autocast_dtype is not None else nullcontext())
        with fp32_exact():
            for k in range(self.mix["checked_steps"]):
                idx = self.frames_of(k)
                img = self.clip[idx].float() / 255.0
                t = torch.from_numpy(frame_times(idx, self.n)).to(
                    self.device)
                with cast:
                    out = self.fam.forward(img, t, p, m)
                loss = ref_train.fusion10_freq(out.float(), img)
                g = torch.autograd.grad(loss, list(p.values()))
                g = dict(zip(p.keys(), g))
                if k == 0:
                    grads = {n: float(v.norm()) for n, v in g.items()}
                opt.step(g, self.lr_of(k))
                losses.append(float(loss.detach()))
        change = {n: float((v.detach() - self.params[n]).norm())
                  for n, v in p.items()}
        return losses, grads, change

    def gaps(self, losses, grads, change) -> Dict[str, float]:
        """Against the reference's (losses, grads, change): the largest
        relative loss gap of the checked steps; the widest gap of a leaf's
        first gradient norm and of its change norm, each against the
        larger of the reference's norm of that leaf and of the median
        leaf; leaves whose reference gradient is under a thousandth of the
        median leaf's move by round-off alone and are left out of the
        change."""
        gaps = [abs(a - b) / abs(b) for a, b in zip(self.losses, losses)]
        g_med = float(np.median(list(grads.values())))
        c_med = float(np.median(list(change.values())))
        moved = [n for n, v in grads.items() if v >= 1e-3 * g_med]
        return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
                "grad_gap": worst(self.grad_norms, grads, g_med),
                "change_gap": worst(self.change_norms, change, c_med, moved)}

    def check(self) -> Dict[str, float]:
        return self.gaps(*self.reference_steps())


KINDS = {"decode": DecodeCell, "train": TrainCell}
