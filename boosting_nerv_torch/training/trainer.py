"""Regression trainer of the five model families (port of
boosting_nerv_tpu/training/trainer.py).

The JAX trainer's orchestration: a seeded init, the seen / unseen split,
the string-schedule learning rate set each step, the loss on (masked)
frames, the 8-slot {pred, quant} x {seen, unseen} x {PSNR, SSIM} eval
with 8-bit PTQ of the decoder weights and 6-bit PTQ of the embeddings,
Huffman bits per parameter and bits per pixel, the decode fps of the
serving decode (the encoder excluded), ``model_latest.ckpt`` each epoch
with auto-resume, and the CSV of results.  The forward dispatches by family
as JAX's ``_forward``: HNeRV-Boost takes (frame, t), HNeRV the frame (or t
without an encoder), the index-only families t.  The HNeRV families with
an encoder quantise their embeddings for the quantised eval; E-NeRV and
E-NeRV-Boost default to ``train_precision="highest"`` and a global clip of
1.0, as in JAX.

On the GPU: the clip stays on the device as uint8 and each step gathers
and normalises its frames there; the step is eager PyTorch (cuDNN
convolutions, autograd), as the JAX step is plain XLA, with TF32 off at
``train_precision="highest"``; ``micro_batch`` accumulates the gradients
of equal chunks and averages them; ``remat`` recomputes the forward in
the backward pass (``torch.utils.checkpoint``).  The fps clock times
``build_serving_decode`` for the three served Boost families, whose
decoder tail runs on the Hopper kernels, and the eager model's decode for
HNeRV and E-NeRV (as JAX times its flax decode for them;
``fps_decode_path``): CUDA events around the decodes on the card, the host
clock on the CPU (where the wrappers run their plain versions).

The regression, inpainting and interpolation tasks are ported.
Interpolation reads a clip as JAX does (the last frame of an even count
dropped; ``data_split`` "1_1_2" trains on the even frames); with
``embed_inter`` the HNeRV families with an encoder decode each
validation frame, in both eval slots, from the mean of its neighbours'
embeddings (``VideoData.neighbours``, gathered from the resident frames).
``dump_images`` / ``dump_videos`` write the last eval's predicted frames
as PNGs (``data/png.py``) and ``gt_pred.gif`` (``data/gif.py``), with no
Pillow; ``profile`` traces steps 2-6 of the first epoch with
``torch.profiler`` (CUDA activity on the card) into a Chrome trace under
``outf/profile/``, the step's spans (``train.step``) among its ranges,
and logs their table; ``planar_train`` is accepted and trains on the
standard forward, with a note: JAX's planar forward is a TPU layout of the
same function.

The mesh (``dp`` x ``sp``, JAX's 'data' and 'spatial' axes,
trainer.py:150-190, 330-338, 518-522, 546-552): the trainer runs in each
rank of a ``parallel.MeshPlan`` (``parallel.launch`` or torchrun start
them; dp sp 1 builds no process group and runs the single-process code).
Every rank holds the whole clip, draws the same epoch order and trains on
its ``shard_batch`` slice (by data index) of each global batch; at sp > 1
the model takes the rank's rows of the (masked) frame and runs split by
rows (``parallel/spatial.py``: the halos by hand, maps whole where the
plan says, the plan printed once by rank 0), and the loss runs unchanged
on the frame gathered on every rank.  ``DistributedDataParallel`` averages
the gradients over all ranks in the backward pass (``micro_batch`` chunks
but the last under ``no_sync``), which by the spatial module's gradient
rule is the gradient of the global batch's loss, the clip included.
Rank 0 owns the logger, the CSV, ``--profile``, the checkpoints (the
unwrapped module, as at dp 1) and the evals (JAX's eval is not sharded),
and broadcasts the eval's metrics; the others write nothing and wait.
The logged loss and PSNR are means over the ranks.  The fps clock times
the eager decode at dp > 1, as JAX leaves its serving decode when
sharded, and at sp > 1 the split eager decode on every rank of a spatial
group (``fps_decode_path`` "sharded"), as JAX times its spatially
sharded flax decode.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.utils.checkpoint

from ..bridge import flax_params_from_torch_state, torch_state_from_flax
from ..compress.huffman import huffman_code_lengths
from ..config import BoostConfig, resolve_sizes
from ..data.gif import write_gif
from ..data.png import read_png, write_png
from ..data.video import VideoData, data_split, make_inpaint_mask
from ..models import build_model
from ..ops.losses import loss_fn
from ..ops.metrics import msssim_per_frame, psnr_per_frame
from ..ops.msssim import ssim
from ..ops.ptq import dequant_tensor, quant_tensor
from ..parallel.mesh import MeshPlan, make_mesh_plan, rank_devices
from ..runtime import fast_decode
from ..utils import tracing
from ..utils.logger import NullLogger, RunLogger
from ..utils.tracing import span
from .adan import Adan
from .checkpoint import load_checkpoint, restore, save_checkpoint
from .schedules import lr_multiplier

METRIC_NAMES = [
    "pred_seen_psnr", "pred_seen_ssim", "pred_unseen_psnr", "pred_unseen_ssim",
    "quant_seen_psnr", "quant_seen_ssim", "quant_unseen_psnr", "quant_unseen_ssim",
]

PROFILE_STEPS = (2, 7)  # profile: trace steps [2, 7) of the first epoch


def set_train_precision(precision: str) -> None:
    """``"highest"``: float32 convolutions and matmuls, TF32 off (cuDNN's
    default is on); ``"high"`` / ``"default"``: TF32 on."""
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown train_precision {precision!r}")
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


class Adam(torch.optim.Optimizer):
    """``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8) followed by
    ``-lr * u``: u = m_hat / (sqrt(v_hat) + eps) with the bias-corrected
    moments."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                k = st["step"]
                mu = st["mu"].copy_((1 - b1) * g + b1 * st["mu"])
                nu = st["nu"].copy_((1 - b2) * (g * g) + b2 * st["nu"])
                mu_hat = mu / (1 - b1 ** k)
                nu_hat = nu / (1 - b2 ** k)
                p.add_(-group["lr"] * (mu_hat / (torch.sqrt(nu_hat)
                                                 + group["eps"])))


def clip_by_global_norm_(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` on the gradients of ``params``, in
    place: g * max_norm / norm when norm >= max_norm, else unchanged."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if bool(norm < max_norm):
        return
    for g in grads:
        g.copy_((g / norm) * max_norm)


def make_optimizer(optim_type: str, params,
                   clip_max_norm: Optional[float] = 0.0
                   ) -> torch.optim.Optimizer:
    """Adan or Adam, matched case-insensitively, with the learning rate
    set per step in ``param_groups``; with ``clip_max_norm`` > 0 every
    step first clips the global gradient norm as optax does."""
    name = optim_type.lower()
    if name == "adan":
        opt = Adan(params, lr=1.0)
    elif name == "adam":
        opt = Adam(params, lr=1.0)
    else:
        raise ValueError(f"unknown optim_type {optim_type}")
    if clip_max_norm and clip_max_norm > 0:
        opt.register_step_pre_hook(lambda o, args, kwargs: clip_by_global_norm_(
            [p for g in o.param_groups for p in g["params"]], clip_max_norm))
    return opt


def _map_leaves(tree: Dict, fn, path=()) -> Dict:
    """A nested dict with ``fn(path, leaf)`` at every leaf."""
    return {k: (_map_leaves(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def enerv_defaults(cfg: BoostConfig) -> BoostConfig:
    """E-NeRV's training defaults (the JAX trainer's, trainer.py:122-140):
    ``train_precision`` forced to "highest" (its transformer trunk
    diverges below full matmul precision) and an unset ``clip_max_norm``
    set to 1.0 (its norm-free residuals need the clip), each with the
    JAX trainer's printed note; other families unchanged."""
    if not cfg.model.startswith("ENeRV"):
        return cfg
    if cfg.train_precision != "highest":
        print(f"train_precision {cfg.train_precision!r} -> 'highest': the "
              "E-NeRV transformer trunk diverges below full matmul "
              "precision (measured, BASELINE.md)")
        cfg = cfg.replace(train_precision="highest")
    if cfg.clip_max_norm is None:
        print("clip_max_norm unset -> 1.0: the E-NeRV trunk's norm-free "
              "residuals need grad clipping on this stack (measured, "
              "BASELINE.md round 4); pass an explicit --clip_max_norm 0 to "
              "disable")
        cfg = cfg.replace(clip_max_norm=1.0)
    return cfg


class _TrainForward(torch.nn.Module):
    """The training forward of ``model`` by family (``forward_of``), under
    ``torch.utils.checkpoint`` with ``remat``: the module DDP wraps, so
    that its reducer sees the forward and the recomputation alike."""

    def __init__(self, model: torch.nn.Module, forward_of, remat: bool,
                 rows=None):
        super().__init__()
        self.model = model
        self.forward_of = forward_of
        self.remat = remat
        self.rows = rows

    def forward(self, img: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return torch.utils.checkpoint.checkpoint(
                self.forward_of, self.model, img, t, self.rows,
                use_reentrant=False)
        return self.forward_of(self.model, img, t, self.rows)


class RegressionTrainer:
    def __init__(self, cfg: BoostConfig, video: Optional[VideoData] = None,
                 logger: Optional[RunLogger] = None,
                 device: Union[str, torch.device] = "cuda",
                 plan: Optional[MeshPlan] = None):
        """``plan``: this rank's plan of the mesh; by default
        ``make_mesh_plan(cfg.dp, cfg.sp)`` on ``device`` (at dp sp > 1 this
        process must be a rank of a group already)."""
        cfg = enerv_defaults(cfg)
        if cfg.clip_max_norm is None:
            cfg = cfg.replace(clip_max_norm=0.0)
        self.cfg0 = cfg
        self.plan = plan if plan is not None else make_mesh_plan(
            cfg.dp, cfg.sp, rank_devices(device, cfg.dp * cfg.sp))
        if (self.plan.dp, self.plan.sp) != (cfg.dp, cfg.sp):
            raise ValueError(f"the plan's mesh is {self.plan.dp}x"
                             f"{self.plan.sp}, the config's {cfg.dp}x"
                             f"{cfg.sp}")
        self.device = self.plan.device
        # the split forward's view of the mesh (None: the unsplit one)
        self.rows = self.plan.rows()
        self.split_plan: Optional[List[str]] = None  # its first forward's
        set_train_precision(cfg.train_precision)
        if cfg.planar_train:
            print(f"planar_train={cfg.planar_train}: the standard forward "
                  "trains here (the planar forward is JAX's TPU layout of "
                  "the same function)")

        self.video = video if video is not None else VideoData.from_dir(
            cfg.data_path, cfg.crop_list, cfg.interpolation, cfg.embed_inter)
        self.cfg = cfg = resolve_sizes(cfg, self.video.final_size,
                                       self.video.n)
        # measure_fps times the serving decode of the families it serves
        # (which must be in its paper config), the eager decode of the
        # others and of an index-only config with no planar tail, which
        # the serving decode refuses (the JAX trainer times its flax
        # decode where its serving decode fails, trainer.py:545-590, and
        # when sharded, :550), the split eager decode at sp > 1 (:518-522)
        self.fps_decode_path = "sharded" if self.plan.sp > 1 else "eager"
        if cfg.model in fast_decode.V5_MODELS:
            fast_decode.check_config(cfg)
            if self.plan.world == 1 and (cfg.model == "HNeRV_Boost"
                                         or fast_decode.has_planar_tail(cfg)):
                self.fps_decode_path = "serving"
        self._sharded_fps: Optional[float] = None  # on_main's clock
        # the HNeRV families with an encoder: embeddings to quantise
        self.has_embed = cfg.is_hnerv_family and bool(cfg.enc_strds)
        # interpolation: validation frames decode from their neighbours'
        # mean embedding
        self.embed_inter = (self.has_embed and cfg.interpolation
                            and cfg.embed_inter)

        split = [int(x) for x in cfg.data_split.split("_")]
        self.train_ind, self.val_ind = data_split(
            list(range(self.video.n)), split, cfg.shuffle_data, 0)
        self.val_ind_set = set(self.val_ind)

        self.model = build_model(cfg, seed=cfg.manualSeed,
                                 device=self.device)
        # the whole clip resident on the device as uint8
        self.frames = torch.from_numpy(self.video.frames).to(self.device)
        self.opt = make_optimizer(cfg.optim_type, self.model.parameters(),
                                  cfg.clip_max_norm)

        h, w = self.video.frames.shape[1:3]
        mask = make_inpaint_mask(h, w, cfg.inpanting)
        self.inpaint_mask = (None if mask is None else torch.from_numpy(
            mask)[None, :, :, None].to(self.device))
        # MS-SSIM needs frames of 176+ pixels a side; single-scale SSIM
        # with a window that fits below that
        self._use_ms = min(h, w) >= 176
        self._ssim_win = min(11, (min(h, w) // 2) * 2 - 1)

        # rank 0 owns the logs
        self.logger = ((logger or RunLogger(cfg.outf)) if self.plan.is_main
                       else NullLogger())
        self._train_forward = None  # built at the first step (DDP's sync)
        self.start_epoch = max(cfg.start_epoch, 0)

        state = self.model.state_dict()
        self.encoder_param = sum(v.numel() for k, v in state.items()
                                 if k.startswith("encoder.")) / 1e6
        self.decoder_param = (sum(v.numel() for v in state.values()) / 1e6
                              - self.encoder_param)
        self.total_param = self.decoder_param + cfg.embed_param / 1e6
        self.fps = 0.0
        self.bits_per_param = 0.0
        self.full_bits_per_param = 0.0
        self.total_bpp = 0.0
        self.best_metrics = {k: 0.0 for k in METRIC_NAMES}
        self.last_eval: Dict[str, float] = {}  # the latest evaluate's
        self.psnr_history: List[float] = []
        self.train_losses: List[float] = []  # every step's loss
        self.train_psnr: List[float] = []    # every epoch's mean PSNR

    # ------------------------------------------------------------------ #
    def gather(self, idx) -> torch.Tensor:
        """Frames ``idx`` of the resident clip as float32 NHWC in [0, 1]."""
        idx = torch.as_tensor(np.asarray(idx), device=self.device)
        return self.frames[idx].to(torch.float32) / 255.0

    def forward(self, img: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The model's output for frames ``img`` at indices ``t``, by
        family (JAX's ``_forward``): HNeRV-Boost (img, t), HNeRV img (t
        without an encoder), the index-only families t; through DDP when
        the plan has a process group (built at the first call, which
        broadcasts rank 0's parameters), split by rows at sp > 1 (the
        output whole on every rank)."""
        return self._forward_module()(img, t)

    def _forward_module(self) -> torch.nn.Module:
        if self._train_forward is None:
            self._train_forward = self.plan.ddp(_TrainForward(
                self.model, self._forward_of, self.cfg.remat, self.rows))
        return self._train_forward

    def _forward_of(self, model, img: torch.Tensor, t: torch.Tensor,
                    rows=None) -> torch.Tensor:
        cfg = self.cfg
        if cfg.model == "HNeRV_Boost":
            return model(img, t, rows)
        if cfg.model == "HNeRV" and cfg.enc_strds:
            return model(img, rows)
        return model(t, rows)

    def _traced(self, forward):
        """``forward()``; the first split forward's plan is kept in
        ``split_plan`` and printed by rank 0."""
        rows = self.rows
        if rows is None or rows.sp == 1 or self.split_plan is not None:
            return forward()
        rows.start_trace()
        out = forward()
        self.split_plan = rows.stop_trace()
        self.logger.print(f"split plan (rank {self.plan.rank}, mesh "
                          f"{self.plan.dp}x{self.plan.sp}): "
                          + "; ".join(self.split_plan))
        return out

    def _loss_backward(self, img: torch.Tensor, t: torch.Tensor):
        """Loss of one chunk, its gradients added to the parameters';
        (loss, output), both detached."""
        mask = self.inpaint_mask
        with span("train.forward"):
            img_in = (torch.clamp(img * mask, 0, 1) if mask is not None
                      else img)
            out = self._traced(lambda: self.forward(img_in, t))
        with span("train.loss"):
            if mask is not None:
                loss = loss_fn(out * mask, img * mask, self.cfg.loss)
            else:
                loss = loss_fn(out, img, self.cfg.loss)
        with span("train.backward"):
            loss.backward()
        return loss.detach(), out.detach()

    def train_step(self, img: torch.Tensor, t: torch.Tensor, lr: float):
        """One optimizer step on the frames ``img`` [B, H, W, 3] at indices
        ``t`` [B] (at dp > 1 this rank's slice of the global batch): (loss,
        per-frame PSNR [B]) of those frames.  The step's gradients (the
        global batch's, averaged over the ranks) stay in the parameters'
        ``.grad`` until the next step (clipped when the optimizer clips).
        ``micro_batch`` chunks a rank's frames; the gradients of all
        chunks but the last accumulate unsynchronised (DDP's
        ``no_sync``), so the ranks all-reduce once a step.

        While a torch profiler records, the step records spans
        (``utils/tracing.py``): ``train.step`` (a unit) holds
        ``train.forward``, ``train.loss`` and ``train.backward`` (once a
        chunk), ``train.psnr`` (the PSNR, and the reductions over chunks)
        and ``train.optim`` (the chunks' gradient average, the lr and the
        optimizer's step); ``train_step_idx`` adds ``train.gather``."""
        with span("train.step", unit=True):
            return self._step(img, t, lr)

    def _step(self, img: torch.Tensor, t: torch.Tensor, lr: float):
        self.opt.zero_grad(set_to_none=True)
        mb = self.cfg.micro_batch
        if mb and img.shape[0] > mb and img.shape[0] % mb == 0:
            n_chunks = img.shape[0] // mb
            losses, psnrs = [], []
            fwd = self._forward_module()
            for k, (ci, ct) in enumerate(zip(img.split(mb), t.split(mb))):
                with (fwd.no_sync()
                      if k < n_chunks - 1 and self.plan.group is not None
                      else contextlib.nullcontext()):
                    loss, out = self._loss_backward(ci, ct)
                losses.append(loss)
                with span("train.psnr"):
                    psnrs.append(psnr_per_frame(out, ci))
            with span("train.psnr"):
                loss = torch.stack(losses).sum() / n_chunks
                psnr = torch.cat(psnrs)
        else:
            n_chunks = 1
            loss, out = self._loss_backward(img, t)
            with span("train.psnr"):
                psnr = psnr_per_frame(out, img)
        with span("train.optim"):
            if n_chunks > 1:
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(n_chunks)
            for group in self.opt.param_groups:
                group["lr"] = lr
            self.opt.step()
        return loss, psnr

    def train_step_idx(self, idx, t, lr: float):
        """``train_step`` on frames ``idx`` of the resident clip."""
        with span("train.step", unit=True):
            with span("train.gather"):
                img = self.gather(idx)
                t = torch.as_tensor(t, device=self.device)
            return self._step(img, t, lr)

    # ------------------------------------------------------------------ #
    def maybe_resume(self):
        cfg = self.cfg
        if cfg.weight not in ("None", "", None):
            ck = load_checkpoint(cfg.weight)
            restore(self.model, ck, cfg)
            self.logger.print(f"=> loaded checkpoint '{cfg.weight}' "
                              f"(epoch {ck['epoch']})")
            self.start_epoch = max(cfg.start_epoch, 0)
        if not cfg.not_resume:
            path = os.path.join(cfg.outf, "model_latest.ckpt")
            if os.path.isfile(path):
                ck = load_checkpoint(path)
                restore(self.model, ck, cfg)
                self.start_epoch = ck["epoch"]
                self.logger.print(
                    f"=> Auto resume loaded checkpoint '{path}' "
                    f"(epoch {ck['epoch']})")

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        self.logger.dump_config(self.cfg0)
        self.maybe_resume()
        n_train_batches = max(len(self.train_ind) // cfg.batchSize, 1)
        t_start = time.time()
        prof = None
        for epoch in range(self.start_epoch, cfg.epochs):
            ep_start = time.time()
            losses, psnrs = [], []
            batches = self.video.epoch_batches(
                self.train_ind, cfg.batchSize, shuffle=True,
                seed=cfg.manualSeed + epoch)
            for i, batch in enumerate(batches):
                if i > 10 and cfg.debug:
                    break
                if (cfg.profile and epoch == self.start_epoch
                        and self.plan.is_main):
                    if i == PROFILE_STEPS[0]:
                        prof = self._start_profile()
                    elif i == PROFILE_STEPS[1] and prof is not None:
                        self._stop_profile(prof)
                        prof = None
                progress = (epoch + i / n_train_batches) / cfg.epochs
                lr = cfg.lr * lr_multiplier(
                    cfg.lr_type, progress, cur_iter=i, epochs=cfg.epochs,
                    full_data_length=self.video.n, cur_epoch=epoch)
                loss, psnr = self.train_step_idx(
                    self.plan.shard_batch(batch["idx"]),
                    self.plan.shard_batch(batch["norm_idx"]), lr)
                # kept on the device: no host sync between steps
                losses.append(loss)
                psnrs.append(psnr)
                if i % cfg.print_freq == 0 or i == n_train_batches - 1:
                    cur = float(self.plan.mean(torch.cat(psnrs).mean()))
                    self.logger.print(
                        f"Epoch[{epoch + 1}/{cfg.epochs}], "
                        f"Step [{i + 1}/{n_train_batches}], lr:{lr:.2e} "
                        f"pred_PSNR: {cur:.4f}")
            if prof is not None:  # an epoch of fewer than 7 steps
                self._stop_profile(prof)
                prof = None

            ep_psnr = (float(self.plan.mean(torch.cat(psnrs).mean()))
                       if psnrs else 0.0)
            if losses:
                self.train_losses += self.plan.mean(
                    torch.stack(losses)).tolist()
            self.train_psnr.append(ep_psnr)
            self.logger.scalar("Train/pred_PSNR", ep_psnr, epoch + 1)
            self.logger.scalar("Train/lr", lr, epoch + 1)
            self.logger.print(
                f"Time/epoch: {time.time() - ep_start:.2f}s avg "
                f"{(time.time() - t_start) / (epoch + 1 - self.start_epoch):.2f}s")

            last = cfg.epochs - epoch
            if (epoch + 1) % cfg.eval_freq == 0 or last in (1, 3, 5):
                results = self.on_main(lambda: self.evaluate(
                    dump_vis=(cfg.dump_images or cfg.dump_videos)
                    and last == 1,
                    huffman_coding=(last == 1)))
                msg = f"Eval at epoch {epoch + 1}: "
                for k in METRIC_NAMES:
                    v = results[k]
                    self.best_metrics[k] = max(self.best_metrics[k], v)
                    if "psnr" in k:
                        self.logger.scalar(f"Val/{k}", v, epoch + 1)
                        if k == "pred_seen_psnr":
                            self.psnr_history.append(v)
                    msg += f"{k}: {v:.4f} | "
                self.logger.print(msg)

            if self.plan.is_main:
                save_checkpoint(os.path.join(cfg.outf, "model_latest.ckpt"),
                                epoch + 1, self.model, cfg, self.opt)
            self.plan.barrier()

        self.train_time = time.time() - t_start
        self.cur_epoch = cfg.epochs
        self.dump_csv(f"epoch{cfg.epochs}.csv")
        self.logger.print(f"Training complete in: {self.train_time:.1f}s")
        return self.best_metrics

    def on_main(self, evaluate, fps_model=None) -> Dict[str, float]:
        """``evaluate()`` (the eight metrics) on rank 0 alone, JAX's eval
        being unsharded; its metrics broadcast, so that every rank's
        ``best_metrics`` agree.  At sp > 1 the fps clock of the split
        decode runs first on every rank (of ``fps_model()``, by default
        the model), and ``evaluate`` reports it."""
        if self.fps_decode_path == "sharded":
            self._sharded_fps = self.measure_fps(
                reps=self._fps_reps(),
                model=None if fps_model is None else fps_model())
        results = (evaluate() if self.plan.is_main
                   else dict.fromkeys(METRIC_NAMES, 0.0))
        return dict(zip(METRIC_NAMES, self.plan.broadcast(
            [results[k] for k in METRIC_NAMES])))

    def _start_profile(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        tracing.reset()
        prof.start()
        return prof

    def _stop_profile(self, prof: torch.profiler.profile) -> None:
        """Stop ``prof``, export its Chrome trace to
        ``outf/profile/trace.json`` and log the profiled steps' spans
        (``tracing.table``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        path = os.path.join(self.cfg.outf, "profile", "trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        self.logger.print(f"profiler trace captured: {path}")
        self.logger.print(tracing.table(tracing.summary()))
        tracing.reset()

    # ------------------------------------------------------------------ #
    def quantize_model_params(self):
        """PTQ: ``quant_model_bit``-bit affine quantisation of every
        non-encoder weight, each in its flax layout as the JAX trainer
        quantises it.  Returns (the quantised state dict, the codes keyed by
        flax path), or (the state dict, None) at ``quant_model_bit`` -1."""
        cfg = self.cfg
        state = self.model.state_dict()
        if cfg.quant_model_bit == -1:
            return state, None
        quant_ckt = {}

        def quant(path, v):
            if any("encoder" in p for p in path):
                return v
            q, new_v = quant_tensor(v, cfg.quant_model_bit)
            quant_ckt["/".join(path)] = q
            return new_v

        tree = _map_leaves(flax_params_from_torch_state(state, cfg), quant)
        return torch_state_from_flax(tree, cfg), quant_ckt

    def _batches(self):
        return self.video.epoch_batches(range(self.video.n),
                                        self.cfg.batchSize, False, 0,
                                        drop_last=False)

    def _collect_embeds(self) -> np.ndarray:
        return np.concatenate([
            self.model.encode(self.gather(b["idx"])).cpu().numpy()
            for b in self._batches()], axis=0)

    def _ssim_metric(self, out, img):
        if self._use_ms:
            return msssim_per_frame(out, img)
        return ssim(out, img, size_average=False, win_size=self._ssim_win)

    def _decoder(self, model: Optional[torch.nn.Module] = None):
        """(decode(embed, t), embed, frames a decode) of ``model`` (by
        default ``self.model``): the serving decode
        (``build_serving_decode`` on its weights), batch 1; or, for HNeRV,
        E-NeRV, an index-only config with no planar tail and any family at
        dp > 1, the eager model's decode of batchSize frames, as JAX times
        its flax decode (trainer.py:495-541): the HNeRV families'
        ``decode`` of the encoder's embedding, the index-only forward;
        split by rows at sp > 1 (the embedding whole).  The encoder is
        excluded; embed is None for the index-only families."""
        cfg = self.cfg
        model = self.model if model is None else model
        if self.fps_decode_path == "serving":
            decode = fast_decode.build_serving_decode(cfg, model)
            embed = (model.encode(self.gather([0]))
                     if cfg.model == "HNeRV_Boost" else None)
            return decode, embed, 1
        b = min(cfg.batchSize, self.video.n)
        rows = self.rows if self.fps_decode_path == "sharded" else None
        if self.has_embed:
            embed = model.encode(self.gather(list(range(b))))
            return (lambda e, t: self._decode(model, e, t.expand(b),
                                              rows)), embed, b
        return (lambda e, t: self._forward_of(model, None, t.expand(b),
                                              rows)), None, b

    @torch.no_grad()
    def measure_fps(self, reps: int = 20,
                    model: Optional[torch.nn.Module] = None) -> float:
        """Frames a second of the decode that ``fps_decode_path`` names
        (``_decoder``) of ``model`` (by default ``self.model``; the
        compression eval times its dequantised copy), the encoder
        excluded: one warm-up decode, then ``reps`` decodes at indices in
        [0.01, 1] timed with CUDA events and one synchronisation on the
        card, with the host clock on the CPU."""
        decode, embed, b = self._decoder(model)
        ts = torch.linspace(0.01, 1.0, reps, device=self.device)
        decode(embed, ts[:1])
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(reps):
                decode(embed, ts[i:i + 1])
            end.record()
            torch.cuda.synchronize(self.device)
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for i in range(reps):
                decode(embed, ts[i:i + 1])
            dt = time.perf_counter() - t0
        return reps * b / dt

    def _decode(self, model: torch.nn.Module, embed: torch.Tensor,
                t: torch.Tensor, rows=None) -> torch.Tensor:
        """``model``'s frames from embeddings (HNeRV ignores ``t``)."""
        if self.cfg.model == "HNeRV_Boost":
            return model.decode(embed, t, rows)
        return model.decode(embed, rows)

    def _fps_reps(self) -> int:
        return 100 if self.cfg.eval_fps else 20

    def eval_fps(self, model: Optional[torch.nn.Module] = None) -> float:
        """An eval's fps: ``measure_fps`` of ``model``, or at sp > 1 the
        split decode's, which ``on_main`` clocked on every rank."""
        if self.fps_decode_path != "sharded":
            return self.measure_fps(reps=self._fps_reps(), model=model)
        if self._sharded_fps is None:
            raise RuntimeError("at sp > 1 the fps clock runs on every rank: "
                               "evaluate through on_main")
        return self._sharded_fps

    def _neighbour_embeds(self, idx, embed: torch.Tensor) -> torch.Tensor:
        """``embed`` of the frames ``idx`` with each validation frame's
        replaced by ``0.5 * (encode(pre) + encode(post))`` of its
        neighbours (``VideoData.neighbours``), the unquantised encoder's."""
        pre, post = self.video.neighbours(idx)
        mixed = 0.5 * (self.model.encode(self.gather(pre))
                       + self.model.encode(self.gather(post)))
        is_val = torch.as_tensor([int(i) in self.val_ind_set for i in idx],
                                 device=self.device)
        return torch.where(is_val.view(-1, *[1] * (embed.dim() - 1)), mixed,
                           embed)

    @torch.no_grad()
    def evaluate(self, dump_vis: bool = False, huffman_coding: bool = False
                 ) -> Dict[str, float]:
        """The 8 slots; with ``dump_vis`` the pred slot's frames as
        ``outf/visualize_model_orig/pred_<idx>_<psnr>.png`` and, with
        ``dump_videos``, ``outf/gt_pred.gif`` of every PNG there."""
        cfg = self.cfg
        params_q, quant_ckt = self.quantize_model_params()
        qmodel = copy.deepcopy(self.model)
        qmodel.load_state_dict(params_q)

        # 6-bit PTQ of the clip's embeddings (the HNeRV families with an
        # encoder); the quantised model decodes from their dequantised
        # values
        quant_embed = dequant_embeds = None
        if self.has_embed:
            quant_embed, _ = quant_tensor(self._collect_embeds(),
                                          cfg.quant_embed_bit)
            dequant_embeds = dequant_tensor(quant_embed).astype(np.float32)

        slots = {k: [] for k in METRIC_NAMES}
        mask = self.inpaint_mask
        vis_dir = os.path.join(cfg.outf, "visualize_model_orig")
        if dump_vis:
            os.makedirs(vis_dir, exist_ok=True)
        for model_ind, model in enumerate([self.model, qmodel]):
            for bi, batch in enumerate(self._batches()):
                if bi > 10 and cfg.debug:
                    break
                img = self.gather(batch["idx"])
                t = torch.as_tensor(batch["norm_idx"], device=self.device)
                idx = batch["idx"]
                if model_ind == 1 and dequant_embeds is not None:
                    # interpolation's neighbour average overrides a
                    # validation frame's dequantised embedding, as in JAX
                    e = torch.from_numpy(dequant_embeds[idx]).to(self.device)
                    if self.embed_inter:
                        e = self._neighbour_embeds(idx, e)
                    out = self._decode(model, e, t)
                elif self.embed_inter:
                    e = self._neighbour_embeds(idx, model.encode(img))
                    out = self._decode(model, e, t)
                else:
                    img_in = (torch.clamp(img * mask, 0, 1)
                              if mask is not None else img)
                    out = self._forward_of(model, img_in, t)
                pv = psnr_per_frame(out, img).cpu().numpy()
                sv = self._ssim_metric(out, img).cpu().numpy()
                for b, frame_idx in enumerate(idx):
                    seen = int(frame_idx) not in self.val_ind_set
                    base = (0 if seen else 2) + 4 * model_ind
                    slots[METRIC_NAMES[base]].append(float(pv[b]))
                    slots[METRIC_NAMES[base + 1]].append(float(sv[b]))
                if dump_vis and model_ind == 0:
                    # truncated to uint8, as JAX's astype
                    frames = (torch.clamp(out, 0, 1) * 255).to(
                        torch.uint8).cpu().numpy()
                    for b, frame_idx in enumerate(idx):
                        write_png(os.path.join(
                            vis_dir, f"pred_{int(frame_idx):04d}_"
                                     f"{pv[b]:.2f}.png"), frames[b])

        if dump_vis and cfg.dump_videos:
            write_gif(os.path.join(cfg.outf, "gt_pred.gif"),
                      (read_png(os.path.join(vis_dir, f))
                       for f in sorted(os.listdir(vis_dir))))

        self.fps = self.eval_fps()
        if huffman_coding and quant_ckt is not None:
            self._huffman_accounting(quant_ckt, quant_embed)

        results = {k: (float(np.mean(v)) if v else 0.0)
                   for k, v in slots.items()}
        self.last_eval = results
        self.logger.print(
            "Eval FPS {:.2f}, ".format(self.fps)
            + " | ".join(f"{k}: {v:.4f}" for k, v in results.items()))
        return results

    def _huffman_accounting(self, quant_ckt, quant_embed):
        """bits/param, bits/param with the fp16 min / scale overhead, and
        bits per pixel of the clip."""
        vals = []
        tmin_scale_len = 0
        if quant_embed is not None:
            vals.append(quant_embed["quant"].ravel())
            tmin_scale_len += (np.asarray(quant_embed["min"]).size
                               + np.asarray(quant_embed["scale"]).size)
        for q in quant_ckt.values():
            vals.append(q["quant"].ravel())
            tmin_scale_len += (np.asarray(q["min"]).size
                               + np.asarray(q["scale"]).size)
        all_vals = np.concatenate(vals)
        unique, counts = np.unique(all_vals, return_counts=True)
        table = {int(u): int(c) for u, c in zip(unique, counts)}
        lengths = huffman_code_lengths(table)
        total_bits = sum(table[s] * lengths[s] for s in table)
        self.bits_per_param = total_bits / len(all_vals)
        total_bits += tmin_scale_len * 16  # fp16 min / scale overhead
        self.full_bits_per_param = total_bits / len(all_vals)
        self.total_bpp = total_bits / self.video.final_size / self.video.n
        self.logger.print(
            f"After quantization and encoding: bits per parameter "
            f"{self.full_bits_per_param:.2f}, bits per pixel "
            f"{self.total_bpp:.4f}")

    # ------------------------------------------------------------------ #
    def dump_csv(self, filename: str):
        cfg = self.cfg
        row = {
            "Vid": cfg.vid, "CurEpoch": getattr(self, "cur_epoch", 0),
            "Time": round(getattr(self, "train_time", 0.0), 1),
            "FPS": round(self.fps, 2), "Split": cfg.data_split,
            "Embed": cfg.embed, "Crop": cfg.crop_list,
            "Lr_type": cfg.lr_type, "LR (E-3)": cfg.lr * 1e3,
            "Batch": cfg.batchSize,
            "Size (M)": f"{round(self.encoder_param, 2)}_"
                        f"{round(self.decoder_param, 2)}_"
                        f"{round(self.total_param, 2)}",
            "ModelSize": cfg.modelsize,
            "Epoch": cfg.epochs, "Loss": cfg.loss, "Act": cfg.act,
            "Norm": cfg.norm, "FC": cfg.fc_hw, "Reduce": cfg.reduce,
            "ENC_type": cfg.conv_type[0],
            "ENC_strds": ",".join(map(str, cfg.enc_strds)),
            "KS": cfg.ks, "enc_dim": cfg.enc_dim,
            "DEC": cfg.conv_type[1],
            "DEC_strds": ",".join(map(str, cfg.dec_strds)),
            "lower_width": cfg.lower_width,
            "Quant": f"quant_M{cfg.quant_model_bit}_E{cfg.quant_embed_bit}",
            "bits/param": round(self.bits_per_param, 4),
            "bits/param w/ overhead": round(self.full_bits_per_param, 4),
            "bits/pixel": round(self.total_bpp, 6),
            f"PSNR_list_{cfg.eval_freq}": ",".join(
                f"{v:.2f}" for v in self.psnr_history),
        }
        row.update({f"best_{k}": round(v, 4)
                    for k, v in self.best_metrics.items()})
        self.logger.dump_csv(row, filename)
