"""The CEM compression trainer (port of
boosting_nerv_tpu/training/compress_trainer.py): a quantisation-aware
finetune with Consistent Entropy Minimisation, then real rANS coding.

- ``maybe_resume`` warm-starts the model from a regression checkpoint
  (``--weight``; a CEM checkpoint's model also) and auto-resumes a CEM run
  whole: model, quantiser parameters and optimizer state, from a
  checkpoint of either package.
- ``init_qparams`` sets every quantiser from the loaded weights' ranges:
  each kernel and bias outside the encoder (``quantizer_w`` /
  ``quantizer_b``, signed, each its bit width and per-channel flag) and,
  for a family with an encoder, the embedding (``quantizer_e``, unsigned,
  from frame 0's embedding; ``embed_entropy`` only adds its rate term).
- ``cem_step`` fake-quantises every tagged weight, runs the forward with
  the dequantised weights (``torch.func.functional_call``; the embedding
  through ``encode``, its quantiser, then ``decode``), and adds the
  noise-relaxed Gaussian rate term ``lambda_rate * bpp`` while
  ``bpp / n_frames > target_bpp``; one optimizer (Adan or Adam, with the
  global clip) updates the model's and the quantisers' parameters
  together, as the JAX step updates its state ``{model, qp, embed_qp}``.
- ``evaluate_cem`` fills the ``quant_*`` slots from the dequantised model
  and, with ``coding``, emits a real rANS stream a tensor (plus 64 bits of
  mean / std a tensor and 32 bits a quantiser parameter): ``total_bpp``
  against the model's estimate ``estimate_bpp``; the fps clock times the
  dequantised model (``eval_fps(model=...)``).

Each quantiser sees a weight in its flax layout (``bridge.flax_view``), so
the quantiser parameters have the JAX trainer's keys and shapes (a
checkpoint's ``qp`` loads in either package) and the codes reach rANS in
JAX's element order; the coding eval's mean / std are numpy's float32
statistics, as JAX takes them.  The training noise U(-1/2, 1/2) comes
from a ``torch.Generator`` seeded with ``manualSeed + 7`` (JAX folds its
key by leaf index, which torch cannot reproduce); ``cem_step`` also takes
the noise as an argument, keyed by flax key and ``EMBED``.
``BNT_CEM_EVAL_LAST_ONLY`` set to anything but "" or "0" skips every eval
but the last (the last-epoch coding eval of a sweep); best-metric
tracking, and so ``model_best.ckpt``, then happens at that eval only.

Data parallelism (JAX: compress_trainer.py:458-472, parameters and
quantiser state replicated): ``init_qparams`` broadcasts rank 0's model
and quantiser parameters; each rank steps on its ``shard_batch`` slice,
with the same weight noise (``noise_gen`` in lockstep) and its slice of
the embedding noise, drawn at the global batch's shape; the embedding's
bits are the global batch's (``embed_rate_bits``: the Gaussian's mean and
std over every rank's codes, each rank's bits summed, all with their
gradient) before the rate term's ``where`` (the term is not linear in
bpp, so ranks on either side of the target would average a gradient
dp=1 never takes), and after ``backward``
every gradient (weights and quantiser parameters) is averaged by one flat
all-reduce (``functional_call`` hides the forward from DDP).  Rank 0 runs
the coding eval and writes the checkpoints, as in the regression trainer.

At sp > 1 (JAX: compress_trainer.py:267, the frame's H over 'spatial')
the encoder and the decoder run split by rows (``parallel/spatial.py``);
the quantisers, the rate term of the weights and the embedding (which
the encoder hands over whole) are computed whole on every rank and
back-propagated unscaled, the spatial module's gradient rule; so the
embedding's Gaussian sums its moments over the data group alone (a sum
over the world would count the whole embedding sp times).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..bridge import flax_key, flax_view, quantizable_leaves, torch_view
from ..compress.rans import gaussian_ans_bits
from ..config import BoostConfig
from ..data.video import VideoData
from ..ops.entropy import gaussian_bits, rate_bits
from ..ops.losses import loss_fn
from ..ops.metrics import psnr_per_frame
from ..ops.quantize import get_quantizer
from ..utils.logger import RunLogger
from .checkpoint import (load_checkpoint, restore, restore_optimizer,
                         restore_qp, save_cem_checkpoint)
from .schedules import lr_multiplier
from ..parallel.mesh import MeshPlan
from .trainer import METRIC_NAMES, RegressionTrainer, make_optimizer

EMBED = "embed"  # cem_step's noise key of the embedding's codes


def eval_last_only() -> bool:
    """``BNT_CEM_EVAL_LAST_ONLY`` is on: set, and neither "" nor "0"."""
    return os.environ.get("BNT_CEM_EVAL_LAST_ONLY", "0") not in ("", "0")


class _Methods(nn.Module):
    """A model's methods by name, for ``functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, method: str, *args):
        return getattr(self.model, method)(*args)


def coding_stats(code: torch.Tensor) -> Tuple[float, float]:
    """(mean, std ddof 1) of a code tensor by numpy in float32, as the JAX
    coding eval takes them (they parameterise the rANS model, so byte
    counts follow them); std 1e-5 for one element."""
    c = code.detach().cpu().numpy()
    return float(c.mean()), (float(c.std(ddof=1)) if c.size > 1 else 1e-5)


def estimate_bits(quant_i: np.ndarray, mean: float, std: float,
                  device) -> float:
    """The Gaussian model's bits of integer codes, summed by numpy in
    float32 as the JAX coding eval sums them."""
    x = torch.from_numpy(quant_i.astype(np.float32)).to(device)
    return float(np.sum(gaussian_bits(x, mean, std).cpu().numpy()))


class CompressionTrainer(RegressionTrainer):
    """The regression trainer plus the CEM quantisation state."""

    def __init__(self, cfg: BoostConfig, video: Optional[VideoData] = None,
                 logger: Optional[RunLogger] = None,
                 device: Union[str, torch.device] = "cuda",
                 plan: Optional[MeshPlan] = None):
        super().__init__(cfg, video=video, logger=logger, device=device,
                         plan=plan)
        cfg = self.cfg
        self.w_quant = get_quantizer(cfg.quantizer_w)
        self.b_quant = get_quantizer(cfg.quantizer_b)
        self.e_quant = get_quantizer(cfg.quantizer_e)
        params = dict(self.model.named_parameters())
        # (flax key, torch name) of every quantised leaf, in flax-key order
        self.leaves = quantizable_leaves(params, cfg)
        self.flax_shapes = {
            k: tuple(flax_view(n, params[n].detach(), cfg).shape)
            for k, n in self.leaves}
        self.qparams: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.embed_qp: Optional[Dict[str, torch.Tensor]] = None
        self.estimate_bpp = 0.0
        self.train_bpp = []  # every step's bpp (bits a pixel of the clip)
        self._resume_ck = None  # a CEM checkpoint for init_qparams
        self._methods = _Methods(self.model)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            cfg.manualSeed + 7)

        # target_bpp from the decoder + embedding budget
        decoder = sum(p.numel() for n, p in self.model.state_dict().items()
                      if "encoder" not in flax_key(n, cfg))
        self.total_param = decoder / 1e6 + cfg.embed_param / 1e6
        self.target_bpp = (cfg.target_bit * self.total_param * 1e6
                           / self.video.final_size / self.video.n)

    # ------------------------------------------------------------------ #
    def _quantizer(self, key: str):
        """(quantiser, bits, per_channel) of the leaf ``key``."""
        cfg = self.cfg
        if key.endswith("/kernel"):
            return self.w_quant, cfg.quant_model_bit, cfg.per_channel_w
        return self.b_quant, cfg.quant_bias_bit, cfg.per_channel_b

    def qp_tensors(self):
        """The quantiser parameters, in key order (the optimizer's order
        after the model's parameters)."""
        out = [v for k in sorted(self.qparams)
               for _, v in sorted(self.qparams[k].items())]
        if self.embed_qp is not None:
            out += [v for _, v in sorted(self.embed_qp.items())]
        return out

    @torch.no_grad()
    def init_qparams(self):
        """Every quantiser from the (loaded) weights' ranges, the
        embedding's from frame 0's embedding; a resumed CEM run's learned
        values replace them, and rank 0's model and quantiser parameters
        are broadcast to every rank.  Then the optimizer over the model's
        and the quantisers' parameters (a resumed run's state
        restored)."""
        cfg = self.cfg
        params = dict(self.model.named_parameters())
        self.qparams = {}
        for key, name in self.leaves:
            Q, bits, pc = self._quantizer(key)
            self.qparams[key] = Q.init_params(
                flax_view(name, params[name], cfg), bits, signed=True,
                per_channel=pc)
        self.embed_qp = None
        if self.has_embed:
            embed = self.model.encode(self.gather([0]))
            self.embed_qp = self.e_quant.init_params(
                embed, cfg.quant_embed_bit, signed=False,
                per_channel=cfg.per_channel_e)
        ck = self._resume_ck
        if ck is not None and "qp" in ck["params"]:
            restore_qp(self.qparams, ck["params"]["qp"])
            if (self.embed_qp is not None
                    and ck["params"].get("embed_qp") is not None):
                restore_qp(self.embed_qp, ck["params"]["embed_qp"])
        self.plan.replicate(list(self.model.parameters())
                            + self.qp_tensors())
        for v in self.qp_tensors():
            v.requires_grad_(True)

        self.opt = make_optimizer(
            cfg.optim_type, list(self.model.parameters()) + self.qp_tensors(),
            cfg.clip_max_norm)
        if ck is not None and ck.get("opt_state") is not None:
            why = restore_optimizer(self.opt, ck["opt_state"])
            if why is not None:
                self.logger.print(f"=> opt_state not restored ({why}); "
                                  "reinitialised")

    # ------------------------------------------------------------------ #
    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.noise_gen,
                          device=self.device) - 0.5

    def dequant_params(self, noise: Optional[Mapping] = None
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(torch name -> dequantised weight in the port's layout, the
        estimated bits of the tagged weights): with ``noise`` (flax key ->
        U(-1/2, 1/2) of the flax shape) the training estimate of the
        noise-relaxed codes, without it 0."""
        cfg = self.cfg
        params = dict(self.model.named_parameters())
        out = {}
        total = torch.zeros((), device=self.device)
        for key, name in self.leaves:
            Q, bits, pc = self._quantizer(key)
            code, _, dq = Q.apply(flax_view(name, params[name], cfg),
                                  self.qparams[key], bits, signed=True,
                                  per_channel=pc)
            if noise is not None:
                total = total + rate_bits(code, noise[key], True)["bitrate"]
            out[name] = torch_view(name, dq, cfg)
        return out, total

    def _call(self, params: Mapping, method: str, *args):
        """``self.model.<method>(*args)`` with ``params`` in place of its
        own parameters of those names."""
        return torch.func.functional_call(
            self._methods, {f"model.{k}": v for k, v in params.items()},
            (method, *args))

    def cem_step(self, img: torch.Tensor, t: torch.Tensor, lr: float,
                 noise: Optional[Mapping] = None):
        """One CEM step on frames ``img`` [B, H, W, 3] at indices ``t`` (at
        dp > 1 this rank's slice of the global batch): (loss of these
        frames, their per-frame PSNR [B], the global batch's bpp), all on
        the device.  ``noise``: flax key -> U(-1/2, 1/2) of the leaf's
        flax shape, and ``EMBED`` -> that of the global batch's embedding
        codes (with ``embed_entropy``; each rank takes its slice); drawn
        from ``noise_gen`` when None."""
        cfg = self.cfg
        draw = noise is None
        if draw:
            noise = {k: self._uniform(s) for k, s in self.flax_shapes.items()}
        self.opt.zero_grad(set_to_none=True)
        mask = self.inpaint_mask
        img_in = torch.clamp(img * mask, 0, 1) if mask is not None else img
        n_frames = self.video.n
        dq, wbits = self.dequant_params(noise)
        out, bpp = self._traced(
            lambda: self._cem_forward(img_in, t, dq, wbits, noise, draw))
        if mask is not None:
            out_loss = loss_fn(out * mask, img * mask, cfg.loss)
        else:
            out_loss = loss_fn(out, img, cfg.loss)
        rate_pen = torch.where(bpp / n_frames > self.target_bpp,
                               cfg.lambda_rate * bpp, torch.zeros_like(bpp))
        loss = out_loss + rate_pen
        loss.backward()
        self.plan.mean_grads(list(self.model.parameters())
                             + self.qp_tensors())
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return loss.detach(), psnr_per_frame(out.detach(), img), bpp.detach()

    def _cem_forward(self, img_in, t, dq, wbits, noise, draw):
        """(the output frames with the dequantised weights ``dq``, the bpp
        with the weights' bits ``wbits``) of one CEM step."""
        cfg, rows = self.cfg, self.rows
        n_frames, final_size = self.video.n, self.video.final_size
        if self.embed_qp is None:
            out = self._forward_of(lambda *a: self._call(dq, "forward", *a),
                                   img_in, t, rows)
            return out, wbits / final_size
        # the encoder is not quantised: its own parameters
        embed = self.model.encode(img_in, rows)
        code_e, _, dequant_e = self.e_quant.apply(
            embed, self.embed_qp, cfg.quant_embed_bit, signed=False,
            per_channel=cfg.per_channel_e)
        bit_embed = 0.0
        if cfg.embed_entropy:
            ne = (self._uniform((self.plan.dp * code_e.shape[0],
                                 *code_e.shape[1:]))
                  if draw else noise[EMBED])
            # the global batch's estimate, before the rate term's where
            bit_embed = (self.embed_rate_bits(
                code_e, self.plan.shard_batch(ne))
                * n_frames / (self.plan.dp * img_in.shape[0]))
        args = ((dequant_e, t) if cfg.model == "HNeRV_Boost"
                else (dequant_e,))
        out = self._call(dq, "decode", *args, rows)
        return out, (wbits + bit_embed) / final_size

    def embed_rate_bits(self, code: torch.Tensor, noise: torch.Tensor
                        ) -> torch.Tensor:
        """``rate_bits(code, noise, True)["bitrate"]`` of the global
        batch's embedding codes, of which ``code`` and ``noise`` are this
        rank's slices (whole on every spatial rank): JAX's one sharded
        tensor, whose Gaussian takes its mean and unbiased std over every
        frame."""
        plan = self.plan
        if plan.data_group is None:
            return rate_bits(code, noise, True)["bitrate"]
        n = code.numel() * plan.dp
        mean = plan.sum_over_data(code.sum()) / n
        std = torch.sqrt(plan.sum_over_data(((code - mean) ** 2).sum())
                         / (n - 1))
        return plan.sum_over_data(torch.sum(gaussian_bits(code + noise, mean,
                                                          std)))

    def cem_step_idx(self, idx, t, lr: float,
                     noise: Optional[Mapping] = None):
        """``cem_step`` on frames ``idx`` of the resident clip."""
        return self.cem_step(self.gather(idx),
                             torch.as_tensor(t, device=self.device), lr,
                             noise)

    # ------------------------------------------------------------------ #
    def save(self, filename: str, epoch: int) -> None:
        """The CEM checkpoint ``filename`` in ``outf``."""
        save_cem_checkpoint(os.path.join(self.cfg.outf, filename), epoch,
                            self.model, self.cfg, self.qparams,
                            self.embed_qp, self.opt)

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        self.logger.dump_config(self.cfg0)
        self.maybe_resume()  # regression weights / auto-resume
        self.init_qparams()  # after the weights are in place
        n_train_batches = max(len(self.train_ind) // cfg.batchSize, 1)
        t_start = time.time()
        for epoch in range(self.start_epoch, cfg.epochs):
            psnrs, losses, bpps = [], [], []
            batches = self.video.epoch_batches(
                self.train_ind, cfg.batchSize, shuffle=True,
                seed=cfg.manualSeed + epoch)
            for i, batch in enumerate(batches):
                if i > 10 and cfg.debug:
                    break
                progress = (epoch + i / n_train_batches) / cfg.epochs
                lr = cfg.lr * lr_multiplier(
                    cfg.lr_type, progress, cur_iter=i, epochs=cfg.epochs,
                    full_data_length=self.video.n, cur_epoch=epoch)
                loss, psnr, bpp = self.cem_step_idx(
                    self.plan.shard_batch(batch["idx"]),
                    self.plan.shard_batch(batch["norm_idx"]), lr)
                # kept on the device: no host sync between steps
                psnrs.append(psnr)
                losses.append(loss)
                bpps.append(bpp)
                if i % cfg.print_freq == 0 or i == n_train_batches - 1:
                    cur = float(self.plan.mean(torch.cat(psnrs).mean()))
                    self.logger.print(
                        f"Epoch[{epoch + 1}/{cfg.epochs}], Step "
                        f"[{i + 1}/{n_train_batches}], lr:{lr:.2e} "
                        f"pred_PSNR: {cur:.2f}, "
                        f"loss:{float(self.plan.mean(loss)):.4f}, "
                        f"bpp:{float(bpp) / self.video.n:.6f}")
            if losses:
                self.train_losses += self.plan.mean(
                    torch.stack(losses)).tolist()
                self.train_bpp += torch.stack(bpps).tolist()
                self.train_psnr.append(float(self.plan.mean(
                    torch.cat(psnrs).mean())))

            last = cfg.epochs - epoch
            is_best = False
            do_eval = (epoch + 1) % cfg.eval_freq == 0 or last in (1, 3, 5)
            if eval_last_only() and last != 1:
                do_eval = False
            if do_eval:
                results = self.on_main(
                    lambda: self.evaluate_cem(coding=(last == 1)),
                    fps_model=self.dequant_model)
                msg = f"Eval at epoch {epoch + 1}: "
                for k in METRIC_NAMES:
                    v = results[k]
                    if k == "quant_seen_psnr":
                        is_best = v >= self.best_metrics[k]
                        self.psnr_history.append(v)
                    self.best_metrics[k] = max(self.best_metrics[k], v)
                    msg += f"{k}: {v:.4f} | "
                self.logger.print(msg)

            if self.plan.is_main:
                self.save("model_latest.ckpt", epoch + 1)
                if is_best:
                    self.save("model_best.ckpt", epoch + 1)
                if (epoch + 1) % cfg.epochs == 0:
                    self.save(f"epoch{epoch + 1}.ckpt", epoch + 1)
            self.plan.barrier()

        self.train_time = time.time() - t_start
        self.cur_epoch = cfg.epochs
        self.dump_csv(f"epoch{cfg.epochs}.csv")
        self.logger.print(f"Training complete in: {self.train_time:.1f}s")
        return self.best_metrics

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def coded_tensors(self) -> Iterator[Tuple[str, torch.Tensor,
                                              np.ndarray]]:
        """(flax key, float codes, integer codes) of every tagged weight,
        in flax-key order and flax element order: what the coding eval
        codes."""
        params = dict(self.model.named_parameters())
        for key, name in self.leaves:
            Q, bits, pc = self._quantizer(key)
            code, quant, _ = Q.apply(flax_view(name, params[name], self.cfg),
                                     self.qparams[key], bits, signed=True,
                                     per_channel=pc)
            yield key, code, quant.cpu().numpy().astype(np.int32)

    def dequant_model(self) -> nn.Module:
        """A copy of the model with the dequantised weights."""
        with torch.no_grad():
            dq, _ = self.dequant_params()
            model = copy.deepcopy(self.model)
            model.load_state_dict(dq, strict=False)
        return model

    @torch.no_grad()
    def evaluate_cem(self, coding: bool = False) -> Dict[str, float]:
        """The eval of the learned quantisers (slots ``quant_*``); with
        ``coding``, real rANS bits and the Gaussian estimate a tensor, with
        the meta bits: ``total_bpp`` and ``estimate_bpp``."""
        cfg = self.cfg
        dq_model = self.dequant_model()
        est_bits, real_bits, meta_bits = 0.0, 0, 0
        if coding:
            for key, code, quant_i in self.coded_tensors():
                mean, std = coding_stats(code)
                est_bits += estimate_bits(quant_i, mean, std, self.device)
                real_bits += gaussian_ans_bits(quant_i, mean, std)
                meta_bits += 2 * 32  # mean / std
                meta_bits += sum(v.numel()
                                 for v in self.qparams[key].values()) * 32

        slots = {k: [] for k in METRIC_NAMES}
        mask = self.inpaint_mask
        for bi, batch in enumerate(self._batches()):
            if bi > 10 and cfg.debug:
                break
            img = self.gather(batch["idx"])
            t = torch.as_tensor(batch["norm_idx"], device=self.device)
            if self.embed_qp is not None:
                embed = dq_model.encode(img)
                code_e, quant_e, dequant_e = self.e_quant.apply(
                    embed, self.embed_qp, cfg.quant_embed_bit, signed=False,
                    per_channel=cfg.per_channel_e)
                # the embedding's bits count only under embed_entropy; it
                # is decoded from its quantised form either way
                if coding and cfg.embed_entropy:
                    qi = quant_e.cpu().numpy().astype(np.int32)
                    m, s = coding_stats(code_e)
                    est_bits += estimate_bits(qi, m, s, self.device)
                    real_bits += gaussian_ans_bits(qi, m, s)
                    meta_bits += 2 * 32
                out = self._decode(dq_model, dequant_e, t)
            else:
                img_in = (torch.clamp(img * mask, 0, 1) if mask is not None
                          else img)
                out = self._forward_of(dq_model, img_in, t)
            pv = psnr_per_frame(out, img).cpu().numpy()
            sv = self._ssim_metric(out, img).cpu().numpy()
            for b, frame_idx in enumerate(batch["idx"]):
                seen = int(frame_idx) not in self.val_ind_set
                base = (0 if seen else 2) + 4  # quant_* slots only
                slots[METRIC_NAMES[base]].append(float(pv[b]))
                slots[METRIC_NAMES[base + 1]].append(float(sv[b]))

        if coding:
            if self.embed_qp is not None:
                meta_bits += sum(v.numel()
                                 for v in self.embed_qp.values()) * 32
            total_pixels = self.video.final_size * self.video.n
            self.total_bpp = (real_bits + meta_bits) / total_pixels
            self.estimate_bpp = (est_bits + meta_bits) / total_pixels
            self.logger.print(
                f"Gaussian Entropy Model real bpp: {self.total_bpp:.6f}, "
                f"estimated bpp: {self.estimate_bpp:.6f}, "
                f"target_bpp: {self.target_bpp:.6f}")

        self.fps = self.eval_fps(model=dq_model)
        results = {k: (float(np.mean(v)) if v else 0.0)
                   for k, v in slots.items()}
        self.logger.print("Eval FPS {:.2f}, ".format(self.fps) + " | ".join(
            f"{k}: {v:.4f}" for k, v in results.items()))
        return results

    def maybe_resume(self):
        """``--weight`` warm-starts the model from a regression checkpoint
        or a CEM checkpoint's model; auto-resume (``model_latest.ckpt`` in
        ``outf``) restores a CEM run whole: the model now, its quantiser
        parameters and optimizer state in ``init_qparams``."""
        cfg = self.cfg
        if cfg.weight not in ("None", "", None):
            ck = load_checkpoint(cfg.weight)
            saved = ck["params"]
            if isinstance(saved, dict) and "model" in saved:
                saved = saved["model"]
            restore(self.model, {"params": saved}, cfg)
            self.logger.print(f"=> loaded checkpoint '{cfg.weight}' "
                              f"(epoch {ck['epoch']})")
        if not cfg.not_resume:
            path = os.path.join(cfg.outf, "model_latest.ckpt")
            if os.path.isfile(path):
                ck = load_checkpoint(path)
                saved = ck["params"]
                if isinstance(saved, dict) and "model" in saved:
                    restore(self.model, {"params": saved["model"]}, cfg)
                    self._resume_ck = ck  # qp, embed_qp, opt_state follow
                else:
                    restore(self.model, {"params": saved}, cfg)
                self.start_epoch = ck["epoch"]
                self.logger.print(f"=> Auto resume loaded '{path}' "
                                  f"(epoch {ck['epoch']})")
