"""String-encoded learning-rate schedules (port of
boosting_nerv_tpu/training/schedules.py), the grammar of the reference's
``adjust_lr``:

- ``cosine_<up_ratio>_<up_pow>_<min_lr>``: polynomial warm-up from
  ``min_lr`` to 1 over the first ``up_ratio`` of training, then cosine
  decay to 0;
- ``hybrid_<up_ratio>_<up_pow>_<down_pow>_<min_lr>_<final_lr>``;
- ``enerv_sch``: a 20% linear warm-up from 0.1 by iteration, then cosine.

Each returns a multiplier of the base learning rate, in plain Python,
evaluated on the host once a step.
"""

from __future__ import annotations

import math


def lr_multiplier(lr_type: str, progress: float, *, cur_iter: int = 0,
                  epochs: int = 1, full_data_length: int = 1,
                  cur_epoch: int = 0) -> float:
    """progress: (epoch + iter / iters_per_epoch) / epochs, in [0, 1)."""
    if "hybrid" in lr_type:
        up_ratio, up_pow, down_pow, min_lr, final_lr = [
            float(x) for x in lr_type.split("_")[1:]]
        if progress < up_ratio:
            return min_lr + (1.0 - min_lr) * (progress / up_ratio) ** up_pow
        return 1 - (1 - final_lr) * ((progress - up_ratio)
                                     / (1.0 - up_ratio)) ** down_pow
    if "cosine" in lr_type:
        up_ratio, up_pow, min_lr = [float(x) for x in lr_type.split("_")[1:]]
        if progress < up_ratio:
            return min_lr + (1.0 - min_lr) * (progress / up_ratio) ** up_pow
        return 0.5 * (math.cos(math.pi * (progress - up_ratio)
                               / (1 - up_ratio)) + 1.0)
    if "enerv_sch" in lr_type:
        all_iter = epochs * full_data_length
        now_iter = cur_epoch * full_data_length + cur_iter
        if now_iter < all_iter * 0.2:
            return 0.1 + 0.9 * now_iter / (all_iter * 0.2)
        whole = all_iter - all_iter * 0.2
        cur = now_iter - all_iter * 0.2
        return 0.5 * (math.cos(math.pi * cur / whole) + 1.0)
    raise NotImplementedError(lr_type)
