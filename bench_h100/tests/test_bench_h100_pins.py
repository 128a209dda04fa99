"""What the cells read, pinned: the parameters and weights, the counts
and the reference's frames of both configurations, so that moving the
harness's code moves none of them.

The values were recorded on the tree before each family's reference moved
into a file of its own (``reference/<model>.py``), by the same arithmetic
through the old entry points (``reference.models.param_shapes``,
``hnerv_decode``, ``nerv_decode``, ``hnerv_forward``, ``stage_plan``),
with torch 2.13.0 on the CPU: shapes and counts at the configurations'
own sizes, weights and frames at ``small.config``'s, float64 frames on
one thread (the order of a convolution's sums follows the thread count).
Digests are the first 32 hex digits of SHA-256 over each tensor's name
and bytes in order.  NeRV-Boost has no training forward, so no
``train_flops`` and no forward is pinned for it.
"""

import hashlib
import json
import os

import pytest
import torch

import small
from bench_h100 import counts, drivers, harness, inputs
from bench_h100.reference import models as ref

SEED = 2 ** 31 + 77
NAMES = ("hnerv_boost_3m_uvg1080p", "nerv_boost_10m_uvg1080p")
SHAPES = {  # name: (digest of [name, shape, init] in order, leaves, numbers)
    "hnerv_boost_3m_uvg1080p": ("8cb357df3504f93b6a6a5929cdc1149d", 269,
                                3131179),
    "nerv_boost_10m_uvg1080p": ("d8732aa431eff3f8a44d6db7f3f5477c", 186,
                                10082175),
}
WEIGHTS = {
    "hnerv_boost_3m_uvg1080p": "9dea6119adf86b54689e6ef62c5371fe",
    "nerv_boost_10m_uvg1080p": "1bbc2fb790629400faccec90d7d26b9f",
}
LEAST_S = {  # name: {precision: counts.decode_least_s}
    "hnerv_boost_3m_uvg1080p": {"bf16": 0.0009258337920647118,
                                "w8a8": 0.0005659951510294943},
    "nerv_boost_10m_uvg1080p": {"bf16": 8.184750747826086e-05,
                                "w8a8": 7.822264256246912e-05},
}
TAIL_BOUNDS = {  # name: {precision: counts.tail_bounds}
    "hnerv_boost_3m_uvg1080p": {
        "bf16": [(2, 0.04029210273003033, "operations"),
                 (3, 0.03770927563195147, "operations"),
                 (4, 0.11222914459049545, "operations"),
                 (5, 0.10532273569261881, "operations"),
                 (6, 0.31373211567239634, "operations"),
                 (7, 0.300258957330637, "operations")],
        "w8a8": [(2, 0.04029210273003033, "operations"),
                 (3, 0.03770927563195147, "operations"),
                 (4, 0.11222914459049545, "operations"),
                 (5, 0.05263475775644265, "operations"),
                 (6, 0.15678679252147548, "operations"),
                 (7, 0.15005361738251644, "operations")]},
    "nerv_boost_10m_uvg1080p": {
        "bf16": [(2, 0.009736904347826087, "operations"),
                 (3, 0.0072460683518705766, "operations"),
                 (4, 0.009661424469160768, "operations"),
                 (5, 0.009907992835820896, "bytes"),
                 (6, 0.01981329671641791, "bytes"),
                 (7, 0.01857197552238806, "bytes")],
        "w8a8": [(2, 0.009736904347826087, "operations"),
                 (3, 0.0037226602985074627, "bytes"),
                 (4, 0.009661424469160768, "operations"),
                 (5, 0.009907992835820896, "bytes"),
                 (6, 0.01981329671641791, "bytes"),
                 (7, 0.01857197552238806, "bytes")]},
}
TRAIN_FLOPS = {"hnerv_boost_3m_uvg1080p": 2772139078272}
FRAMES = {  # name: (float64 decode, its 8-bit stages, training forward)
    "hnerv_boost_3m_uvg1080p": ("7c123c2a1b0a62d9fb75f46a957f106f",
                                "cb28f16a61efa9718fdc5b62d6990909",
                                "fcf4286c9709484236b775895406ade2"),
    "nerv_boost_10m_uvg1080p": ("22b6cbd6393be8e7aea7a61ee59a2611",
                                "209510c340c2bf34c94fed77ee8d6495", None),
}


def _digest(named):
    h = hashlib.sha256()
    for name, v in named:
        h.update(name.encode())
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def _full(name):
    return harness.load_json(os.path.join(small.ROOT, "bench_h100",
                                          "configs", name + ".json"))


@pytest.mark.parametrize("name", NAMES)
def test_parameters_are_pinned(name):
    m = _full(name)["model"]
    shapes = harness.family(m["model"]).param_shapes(m)
    digest = hashlib.sha256(json.dumps(
        [[k, list(s), i] for k, (s, i) in shapes.items()]).encode())
    assert (digest.hexdigest()[:32], len(shapes),
            sum(torch.Size(s).numel() for s, _ in shapes.values())) \
        == SHAPES[name]


@pytest.mark.parametrize("name", NAMES)
def test_weights_are_pinned(name):
    m = small.config(name)["model"]
    assert _digest(inputs.make_weights(m, SEED, "cpu").items()) \
        == WEIGHTS[name]


@pytest.mark.parametrize("name", NAMES)
def test_counts_are_pinned(name):
    cfg = _full(name)
    for precision in ("bf16", "w8a8"):
        assert counts.decode_least_s(cfg, precision) \
            == LEAST_S[name][precision]
        assert counts.tail_bounds(cfg, precision) \
            == TAIL_BOUNDS[name][precision]
    if name in TRAIN_FLOPS:
        assert counts.train_flops(cfg, 1) == TRAIN_FLOPS[name]


@pytest.mark.parametrize("name", NAMES)
def test_reference_frames_are_pinned(name):
    m = small.config(name)["model"]
    fam = harness.family(m["model"])
    p = {k: v.double() for k, v in inputs.make_weights(m, SEED, "cpu").items()}
    t = torch.from_numpy(drivers.frame_times([0, 2], 4)).double()
    x = fam.frame_inputs(m, 2, SEED, "cpu")
    x = None if x is None else x.double()

    def dec(x_, t_, quant=None, calib=None):
        return fam.decode(x_, t_, p, m, quant, calib)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            got = [_digest([("f", dec(x, t))])]
            stages = ref.w8a8_stages(m, fam.stage_plan(m))
            q = ref.Quant(tuple(stages), 8)
            q.bounds = ref.calibrate(dec, [(x, t)], stages, q.margin)
            got.append(_digest([("f", dec(x, t, quant=q))]))
            got.append(None)
            if hasattr(fam, "forward"):
                img = inputs.make_clip(2, 240, 240, SEED,
                                       "cpu").double() / 255
                got[2] = _digest([("f", fam.forward(img, t, p, m))])
    finally:
        torch.set_num_threads(threads)
    assert tuple(got) == FRAMES[name]
