#!/usr/bin/env python
"""Compression entry point of the port: the CEM quantisation-aware
finetune and the rANS coding eval (``training.compress_trainer``) on one
GPU, or over a mesh of several (``--dp``, ``-d``, ``--sp``: as the
regression CLI).

    python -m boosting_nerv_torch.train_nerv_compression \\
        --data_path <dir of frames> --weight <regression checkpoint> ... \\
        [--eval_only] [--device cpu]

The port CLI's flags (``train_nerv_all.build_parser``, the JAX CLI's
spellings and defaults, plus ``--device``) and the ten compression flags
of the JAX package's ``train_nerv_compression.py`` with its defaults;
``--quant`` is always on.  ``--eval_only`` loads the weights
(``--weight``, or the run's ``model_latest.ckpt``), sets the quantisers
and runs the coding eval: ``eval.csv``, and a line appended to
``eval.txt``.
"""

from __future__ import annotations

from boosting_nerv_torch.parallel import launch
from boosting_nerv_torch.train_nerv_all import (args_to_config, build_parser,
                                                mesh_args, record_eval_only)


def build_compression_parser():
    p = build_parser()
    p.add_argument('--quant_bias_bit', type=int, default=8)
    p.add_argument('--per_channel_w', action='store_true', default=False)
    p.add_argument('--per_channel_b', action='store_true', default=False)
    p.add_argument('--per_channel_e', action='store_true', default=False)
    p.add_argument('--quantizer_w', type=str, default='lsq')
    p.add_argument('--quantizer_b', type=str, default='lsq')
    p.add_argument('--quantizer_e', type=str, default='lsqv2')
    p.add_argument('--embed_entropy', action='store_true', default=False)
    p.add_argument('--target_bit', type=float, default=5)
    p.add_argument('--lambda_rate', default=0.2, type=float)
    return p


def compression_config(args):
    """The config of parsed compression flags ``args``: the regression
    CLI's, ``quant`` on, and the ten compression fields."""
    return args_to_config(args).replace(
        quant=True, quant_bias_bit=args.quant_bias_bit,
        per_channel_w=args.per_channel_w, per_channel_b=args.per_channel_b,
        per_channel_e=args.per_channel_e, quantizer_w=args.quantizer_w,
        quantizer_b=args.quantizer_b, quantizer_e=args.quantizer_e,
        embed_entropy=args.embed_entropy, target_bit=args.target_bit,
        lambda_rate=args.lambda_rate)


def run_config(cfg, device, plan=None):
    """Trains, or with ``eval_only`` runs the coding eval once (on rank 0);
    returns the best metrics."""
    from boosting_nerv_torch.training.compress_trainer import \
        CompressionTrainer

    trainer = CompressionTrainer(cfg, device=device, plan=plan)
    trainer.logger.print(
        f"model {cfg.model} fc_dim {trainer.cfg.fc_dim} frames "
        f"{trainer.video.n} target_bpp {trainer.target_bpp:.6f} device "
        f"{trainer.device} dp {trainer.plan.dp} sp {trainer.plan.sp}")
    if not cfg.eval_only:
        return trainer.train()

    trainer.maybe_resume()
    trainer.init_qparams()
    results = trainer.on_main(lambda: trainer.evaluate_cem(coding=True),
                              fps_model=trainer.dequant_model)
    if trainer.plan.is_main:
        record_eval_only(trainer, results)
    return trainer.best_metrics


def _rank_run(plan, cfg, device):
    return run_config(cfg, device, plan)


def main(argv=None):
    """The CLI on ``argv``; at dp sp > 1 on every rank (``launch``);
    returns the best metrics (rank 0's)."""
    args = build_compression_parser().parse_args(argv)
    cfg = compression_config(args)
    if cfg.dp * cfg.sp > 1:
        return launch(_rank_run, mesh_args(cfg, args.device),
                      args=(cfg, args.device))[0]
    return run_config(cfg, args.device)


if __name__ == '__main__':
    main()
