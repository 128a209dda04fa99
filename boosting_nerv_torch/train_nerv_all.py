#!/usr/bin/env python
"""Training entry point of the port: video regression, inpainting and
interpolation of any of the five model families (``--model`` NeRV_Boost,
ENeRV, ENeRV_Boost, HNeRV_Boost or HNeRV) on one GPU, or over a mesh of
several: data-parallel and split by rows.

    python -m boosting_nerv_torch.train_nerv_all --data_path <dir of frames> \\
        --model HNeRV_Boost ... [--eval_only] [--device cpu]

The flag spellings and defaults of the JAX package's ``train_nerv_all.py``
(the reference trainer's), so the recipes under ``scripts/`` give the same
config (``python -m boosting_nerv_torch.recipes <script.sh>`` runs one on
the port), plus ``--device`` (default ``cuda``; ``cpu`` runs every kernel
wrapper's plain version).  Output goes to
``output/<outf>/<vid>/Size<modelsize>`` (``output/debug/...`` with
``--debug``).  ``--interpolation`` / ``--embed_inter`` train on the even
frames and test on the odd ones; ``--eval_only`` loads the weights
(``--weight``, or the run's ``model_latest.ckpt``) and evaluates once:
``eval.csv``, and a line appended to ``eval.txt``; ``--dump_images`` /
``--dump_videos`` write the last eval's frames as PNGs and
``gt_pred.gif``; ``--profile`` traces train steps 2-6 into
``profile/trace.json``; ``--planar_train`` trains on the standard forward.
``--dp N`` trains data-parallel on N ranks (``boosting_nerv_torch.parallel``):
``cuda:0 .. cuda:N-1`` over NCCL, or with ``--device cpu`` N CPU processes
over gloo; ``-d`` without ``--dp`` takes every card (one rank on the
CPU), as the JAX CLI takes every device.  ``--sp M`` splits frames and
maps by rows over M ranks a data shard (``parallel/spatial.py``; dp M
ranks in all, rank d M + s: ``--dp 1 --sp 2 --device cpu`` two gloo
processes, ``--device cuda:0`` two ranks sharing the card over gloo).
Unless torchrun started this process as a rank, the CLI starts the ranks
itself; rank 0 writes the outputs.  ``--cabac``, ``--encoder_file``,
``--dump_values``, ``--dump_features``, ``--block_params``, ``--quant``,
``--quant_axis``, ``--workers`` and ``--resize_list`` are parsed and
unused, as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch

from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.parallel import launch
from boosting_nerv_torch.parallel.mesh import rank_devices


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # Dataset parameters
    p.add_argument('--data_path', type=str, default='')
    p.add_argument('--vid', type=str, default='k400_train0')
    p.add_argument('--shuffle_data', action='store_true')
    p.add_argument('--data_split', type=str, default='1_1_1')
    p.add_argument('--crop_list', type=str, default='640_1280')
    p.add_argument('--resize_list', type=str, default='-1')
    # Architecture
    p.add_argument('--model', type=str, default='')
    p.add_argument('--embed', type=str, default='')
    p.add_argument('--ks', type=str, default='0_3_3')
    p.add_argument('--enc_blks', type=int, default=1)
    p.add_argument('--enc_strds', type=int, nargs='+', default=[])
    p.add_argument('--enc_dim', type=str, default='64_16')
    p.add_argument('--modelsize', type=float, default=1.5)
    p.add_argument('--saturate_stages', type=int, default=-1)
    p.add_argument('--lfreq', type=str, default='pi')
    p.add_argument('--fc_dim', type=int, default=None)
    p.add_argument('--fc_hw', type=str, default='9_16')
    p.add_argument('--reduce', type=float, default=1.2)
    p.add_argument('--lower_width', type=int, default=32)
    p.add_argument('--dec_strds', type=int, nargs='+', default=[5, 3, 2, 2, 2])
    p.add_argument('--dec_blks', type=int, nargs='+', default=[1, 1, 1, 1, 1])
    p.add_argument('--conv_type', type=str, nargs='+',
                   default=['convnext', 'pshuffel'])
    p.add_argument('--norm', default='none', type=str)
    p.add_argument('--act', type=str, default='gelu')
    p.add_argument('--sft_block', type=str, default='none')
    p.add_argument('--ch_t', type=int, default=32)
    p.add_argument('--block_dim', type=int, default=128)
    # Training
    p.add_argument('-j', '--workers', type=int, default=4)
    p.add_argument('-b', '--batchSize', type=int, default=1)
    p.add_argument('--start_epoch', type=int, default=-1)
    p.add_argument('--not_resume', action='store_true')
    p.add_argument('-e', '--epochs', type=int, default=5)
    p.add_argument('--block_params', type=str, default='1_1')
    p.add_argument('--lr', type=float, default=0.001)
    p.add_argument('--lr_type', type=str, default='cosine_0.1_1_0.1')
    p.add_argument('--loss', type=str, default='Fusion6')
    p.add_argument('--out_bias', default='tanh', type=str)
    p.add_argument('--optim_type', default='adan', type=str)
    # default None = unset (reference default 0. = disabled); an explicit
    # 0 disables clipping even for the ENeRV family (which substitutes 1.0
    # only when the flag was not given — trainer.py)
    p.add_argument('--clip_max_norm', default=None, type=float)
    p.add_argument('--inpanting', default='none', type=str)
    p.add_argument('--interpolation', action='store_true', default=False)
    p.add_argument('--embed_inter', action='store_true', default=False)
    p.add_argument('--cabac', action='store_true', default=False)
    # Evaluation
    p.add_argument('--quant', action='store_true', default=False)
    p.add_argument('--eval_only', action='store_true', default=False)
    p.add_argument('--eval_freq', type=int, default=10)
    p.add_argument('--quant_model_bit', type=int, default=8)
    p.add_argument('--quant_embed_bit', type=int, default=6)
    p.add_argument('--quant_axis', type=int, default=0)
    p.add_argument('--dump_images', action='store_true', default=False)
    p.add_argument('--dump_videos', action='store_true', default=False)
    p.add_argument('--eval_fps', action='store_true', default=False)
    p.add_argument('--encoder_file', default='', type=str)
    p.add_argument('--dump_values', action='store_true', default=False)
    p.add_argument('--dump_features', action='store_true', default=False)
    p.add_argument('--profile', action='store_true', default=False,
                   help='capture a torch.profiler trace of train steps 2-6')
    # Distributed / parallel
    p.add_argument('--manualSeed', type=int, default=1)
    p.add_argument('-d', '--distributed', action='store_true', default=False)
    p.add_argument('--dp', type=int, default=0,
                   help='data-parallel size (0 = 1, or every card with -d)')
    p.add_argument('--sp', type=int, default=1,
                   help='spatial sharding size: ranks a frame is split '
                        'over by rows')
    p.add_argument('--remat', action='store_true',
                   help='recompute the forward in the backward pass '
                        '(saves activation memory)')
    p.add_argument('--micro_batch', type=int, default=0,
                   help='gradient-accumulation micro-batch size: b>=2 '
                        'batches at the activation memory of this many '
                        'frames (0 = off)')
    p.add_argument('--train_precision', type=str, default='highest',
                   choices=['highest', 'high', 'default'],
                   help='highest: float32 with TF32 off; high, default: '
                        'TF32 on')
    p.add_argument('--planar_train', type=int, default=0,
                   help="JAX's planar training forward (a TPU layout): the "
                        'standard forward trains here')
    # Logging / output
    p.add_argument('--debug', action='store_true')
    p.add_argument('-p', '--print-freq', default=50, type=int)
    p.add_argument('--weight', default='None', type=str)
    p.add_argument('--overwrite', action='store_true')
    p.add_argument('--outf', default='unify')
    p.add_argument('--suffix', default='')
    p.add_argument('--device', default='cuda',
                   help='cuda (the card) or cpu')
    return p


def args_to_config(args) -> BoostConfig:
    if args.debug:
        args.eval_freq = 1
        outf = 'output/debug'
    else:
        outf = os.path.join('output', args.outf)
    outf = os.path.join(outf, f'{args.vid}/Size{args.modelsize}')
    # under torchrun, rank 0 alone clears the output dir
    if (args.overwrite and os.path.isdir(outf)
            and os.environ.get('RANK', '0') == '0'):
        print('Will overwrite the existing output dir!')
        shutil.rmtree(outf)
    os.makedirs(outf, exist_ok=True)
    dp = args.dp
    if dp == 0:  # -d: every card, as the JAX CLI takes every device
        dp = 1
        if args.distributed and torch.device(args.device).type == 'cuda':
            dp = torch.cuda.device_count()
            if not dp:
                raise ValueError('-d: torch sees no CUDA device')

    return BoostConfig(
        data_path=args.data_path, vid=args.vid,
        shuffle_data=args.shuffle_data, data_split=args.data_split,
        crop_list=args.crop_list, resize_list=args.resize_list,
        model=args.model, embed=args.embed, ks=args.ks,
        enc_blks=args.enc_blks, enc_strds=args.enc_strds,
        enc_dim=args.enc_dim, modelsize=args.modelsize,
        saturate_stages=args.saturate_stages, lfreq=args.lfreq,
        fc_dim=args.fc_dim, fc_hw=args.fc_hw, reduce=args.reduce,
        lower_width=args.lower_width, dec_strds=args.dec_strds,
        dec_blks=args.dec_blks, conv_type=args.conv_type, norm=args.norm,
        act=args.act, sft_block=args.sft_block, ch_t=args.ch_t,
        block_dim=args.block_dim, out_bias=args.out_bias,
        workers=args.workers, batchSize=args.batchSize,
        start_epoch=args.start_epoch, not_resume=args.not_resume,
        epochs=args.epochs, lr=args.lr, lr_type=args.lr_type,
        loss=args.loss, optim_type=args.optim_type,
        clip_max_norm=args.clip_max_norm, inpanting=args.inpanting,
        interpolation=args.interpolation, embed_inter=args.embed_inter,
        quant=args.quant, quant_model_bit=args.quant_model_bit,
        quant_embed_bit=args.quant_embed_bit, quant_axis=args.quant_axis,
        eval_only=args.eval_only, eval_freq=args.eval_freq,
        dump_images=args.dump_images, dump_videos=args.dump_videos,
        eval_fps=args.eval_fps, manualSeed=args.manualSeed,
        debug=args.debug, print_freq=args.print_freq, weight=args.weight,
        overwrite=args.overwrite, outf=outf, suffix=args.suffix,
        dp=dp, sp=args.sp, profile=args.profile,
        remat=args.remat, micro_batch=args.micro_batch,
        train_precision=args.train_precision,
        planar_train=args.planar_train,
    )


def mesh_args(cfg, device) -> dict:
    """``launch``'s plan arguments for ``cfg``'s dp / sp on ``device``."""
    return dict(dp=cfg.dp, sp=cfg.sp,
                devices=rank_devices(device, cfg.dp * cfg.sp))


def run(argv=None):
    """The CLI on ``argv`` in this process (at dp > 1 a rank that torchrun
    started): trains, or with ``--eval_only`` evaluates once; returns the
    trainer."""
    args = build_parser().parse_args(argv)
    return run_config(args_to_config(args), args.device)


def run_config(cfg, device, plan=None):
    """``run`` of a parsed config, on ``plan``'s rank when given."""
    from boosting_nerv_torch.training.trainer import RegressionTrainer

    trainer = RegressionTrainer(cfg, device=device, plan=plan)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    trainer.logger.print(
        f"model {cfg.model} fc_dim {trainer.cfg.fc_dim} frames "
        f"{trainer.video.n} params {round(n_params / 1e6, 4)}M "
        f"device {trainer.device} dp {trainer.plan.dp} sp {trainer.plan.sp}")
    if not cfg.eval_only:
        trainer.train()
        return trainer

    trainer.maybe_resume()
    results = trainer.on_main(lambda: trainer.evaluate(  # on rank 0
        dump_vis=cfg.dump_images or cfg.dump_videos, huffman_coding=True))
    if trainer.plan.is_main:
        record_eval_only(trainer, results)
    return trainer


def _rank_run(plan, cfg, device):
    """A rank of ``main``'s launch: its best metrics."""
    return run_config(cfg, device, plan).best_metrics


def record_eval_only(trainer, results) -> None:
    """An ``--eval_only`` run's records: ``results`` into the best metrics,
    ``cur_epoch`` the config's epochs and ``train_time`` 0, ``eval.csv``,
    and the best metrics appended to ``eval.txt``."""
    for k, v in results.items():
        trainer.best_metrics[k] = max(trainer.best_metrics[k], v)
    trainer.cur_epoch = trainer.cfg.epochs
    trainer.train_time = 0.0
    trainer.dump_csv('eval.csv')
    with open(os.path.join(trainer.cfg.outf, 'eval.txt'), 'a') as f:
        f.write(' | '.join(f'best_{k}: {v:.4f}'
                           for k, v in trainer.best_metrics.items())
                + '\n\n')


def main(argv=None):
    """``run``, or at dp sp > 1 ``run`` on every rank (``launch``: this
    process's rank under torchrun, else dp sp ranks started here); returns
    the best metrics (rank 0's)."""
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)
    if cfg.dp * cfg.sp > 1:
        return launch(_rank_run, mesh_args(cfg, args.device),
                      args=(cfg, args.device))[0]
    return run_config(cfg, args.device).best_metrics


if __name__ == '__main__':
    main()
