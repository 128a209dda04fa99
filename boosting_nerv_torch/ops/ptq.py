"""Post-training quantisation of the regression eval (port of
``quant_tensor`` / ``dequant_tensor`` in boosting_nerv_tpu/ops/ptq.py).

The reference's rule: the candidates are the whole-tensor affine grid
(min and scale in fp32) and one grid per axis whose min / scale overhead
is under 2% of the element count (min and scale in fp16); the candidate of
least mean absolute error wins.  Codes are uint8 (up to 8 bits).  Host-side
numpy: it runs once an eval.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_EPS = 1e-19


def quant_tensor(t: np.ndarray, bits: int = 8) -> Tuple[Dict, np.ndarray]:
    """(``{"quant": uint8 codes, "min", "scale"}``, the dequantised
    float32 tensor)."""
    t = np.asarray(t, dtype=np.float32)
    qmax = 2 ** bits - 1
    candidates = []  # (t_min, scale), possibly axis-shaped

    t_min, t_max = t.min(), t.max()
    candidates.append((np.float32(t_min),
                       np.float32((t_max - t_min) / qmax)))
    for axis in range(t.ndim):
        a_min = t.min(axis=axis, keepdims=True)
        a_max = t.max(axis=axis, keepdims=True)
        if a_min.size / t.size < 0.02:
            scale = ((a_max - a_min) / qmax).astype(np.float16)
            candidates.append((a_min.astype(np.float16), scale))

    best = None
    for t_min_c, scale_c in candidates:
        tm = np.broadcast_to(np.asarray(t_min_c, np.float32), t.shape)
        sc = np.broadcast_to(np.asarray(scale_c, np.float32), t.shape)
        quant = np.clip(np.round((t - tm) / (sc + _EPS)), 0, qmax)
        new_t = tm + sc * quant
        err = np.abs(t - new_t).mean()
        if best is None or err < best[0]:
            best = (err, quant, new_t, t_min_c, scale_c)

    _, quant, new_t, t_min_c, scale_c = best
    quant_t = {"quant": quant.astype(np.uint8), "min": t_min_c,
               "scale": scale_c}
    return quant_t, new_t.astype(np.float32)


def dequant_tensor(quant_t: Dict) -> np.ndarray:
    quant = quant_t["quant"].astype(np.float32)
    tm = np.asarray(quant_t["min"], np.float32)
    sc = np.asarray(quant_t["scale"], np.float32)
    return tm + sc * quant
