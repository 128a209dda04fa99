"""The benchmark's yardstick on the CPU: inputs and traffic from the
seed, the operation counts, the reference, the spec's files, the metric
readers and what may be imported."""

import ast
import glob
import json
import math
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import small
from bench_h100 import counts, drivers, harness, inputs, readers
from bench_h100.reference import models as ref
from bench_h100.trace import Trace

BENCH = os.path.join(small.ROOT, "bench_h100")
SEED = 2 ** 31 + 77   # seeds past 32 signed bits are taken whole
# the small configurations of every family: the cells' two, and
# E-NeRV-Boost's, built in the tests (with heads of 64 both wider than the
# trunk's blocks and as wide, where its 1-head attention has no output
# linear)
FAMILIES = {
    "hnerv_boost_3m_uvg1080p": lambda: small.config("hnerv_boost_3m_uvg1080p"),
    "nerv_boost_10m_uvg1080p": lambda: small.config("nerv_boost_10m_uvg1080p"),
    "enerv_boost": small.enerv_boost,
    "enerv_boost_d64": lambda: small.enerv_boost(block_dim=64),
}


def test_inputs_follow_the_seed():
    m = small.config("hnerv_boost_3m_uvg1080p")["model"]
    a = inputs.make_weights(m, SEED, "cpu")
    b = inputs.make_weights(m, SEED, "cpu")
    c = inputs.make_weights(m, SEED + 1, "cpu")
    assert a.keys() == b.keys() == set(
        harness.family(m["model"]).param_shapes(m))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.weight"], c["head.weight"])
    assert torch.equal(inputs.make_embeds(3, (2, 2, 8), SEED, "cpu"),
                       inputs.make_embeds(3, (2, 2, 8), SEED, "cpu"))
    clip = inputs.make_clip(3, 24, 32, SEED, "cpu")
    assert clip.dtype == torch.uint8 and clip.shape == (3, 24, 32, 3)
    assert torch.equal(clip, inputs.make_clip(3, 24, 32, SEED, "cpu"))
    assert not torch.equal(clip[0], clip[2])   # the frames differ


@pytest.mark.parametrize("mix", ["playback_w8a8", "seek_bf16"])
def test_decode_traffic_follows_the_seed(mix):
    cfg = small.config("nerv_boost_10m_uvg1080p", frames=120)

    def order(seed):
        cell = drivers.DecodeCell(cfg, small.mix(mix), seed, "cpu")
        out = []
        for _ in range(200):
            out.append(cell.next_index())
            cell.units += 1
        return out, cell.sample, cell.calib_idx

    assert order(SEED) == order(SEED)
    seq = order(SEED)[0]
    if mix == "playback_w8a8":    # in order, looped
        assert seq == [i % 120 for i in range(200)]
    else:                         # uniform draws
        assert seq != order(SEED + 1)[0] and len(set(seq)) > 60


def test_train_traffic_follows_the_seed():
    cfg = small.config("hnerv_boost_3m_uvg1080p", frames=120)
    a = drivers.TrainCell(cfg, small.mix("train"), SEED, "cpu")
    b = drivers.TrainCell(cfg, small.mix("train"), SEED, "cpu")
    epoch = [a.frames_of(k)[0] for k in range(120)]
    assert epoch == [b.frames_of(k)[0] for k in range(120)]
    assert sorted(epoch) == list(range(120))      # a permutation
    assert epoch != [a.frames_of(k)[0] for k in range(120, 240)]
    # the recipe's warm-up: 0.1 of the peak at the start, rising
    assert a.lr_of(0) == pytest.approx(0.0003)
    assert a.lr_of(1) > a.lr_of(0)


def test_frame_times_are_rounded_once():
    t = drivers.frame_times(np.arange(120), 120)
    assert t.dtype == np.float32
    assert all(float(v) == float(np.float32(i + 1) / np.float32(120))
               for i, v in enumerate(t))


def test_stage_bound_matches_a_hand_count():
    """Stage 7 of HNeRV-Boost at 1080p in bf16: the conv, the ResBlockSFT's
    two convs (51 -> 51, 3x3) and the 3x3 head to RGB."""
    cfg = harness.load_json(os.path.join(
        BENCH, "configs", "hnerv_boost_3m_uvg1080p.json"))
    px = 1080 * 1920
    ops = 2 * (3 * px * 51 * 51 * 9 + px * 51 * 3 * 9)
    nbytes = (px * 51 * 2 + px * 3 * 2 + 16 * 51
              + 2 * (3 * 51 * 9 * 51 + 3 * 9 * 51 + 3 * 51 + 3))
    want = max(ops / 989e12, nbytes / 3.35e12) * 1e3
    stage, ms, what = counts.tail_bounds(cfg, "bf16")[-1]
    assert (stage, what) == (7, "operations")
    assert ms == pytest.approx(want, rel=1e-12)
    # in W8A8 the same stage runs its convs at the int8 peak
    assert counts.tail_bounds(cfg, "w8a8")[-1][1] == pytest.approx(
        ops / 1979e12 * 1e3, rel=1e-12)
    head = counts.decoder_layers(cfg)[-1]
    assert (head.name, head.macs) == ("head", px * 51 * 3 * 9)


def _tiny_pe(cfg):
    cfg["model"]["embed"] = "pe_1.25_8"   # top frequency 6: no float32 ulp
    return cfg


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_reference_agrees_with_itself_in_float64(name):
    cfg = _tiny_pe(FAMILIES[name]())
    m = cfg["model"]
    fam = harness.family(m["model"])
    p32 = inputs.make_weights(m, SEED, "cpu")
    p64 = {k: v.double() for k, v in p32.items()}
    x = fam.frame_inputs(m, 1, SEED, "cpu")
    t = torch.tensor([0.25])

    def dec(p, dtype, quant=None, calib=None):
        return fam.decode(None if x is None else x.to(dtype), t.to(dtype),
                          p, m, quant, calib)

    a, b = dec(p64, torch.float64), dec(p64, torch.float64)
    assert torch.equal(a, b)
    assert (dec(p32, torch.float32).double() - a).abs().max() < 1e-4
    # the 8-bit stages sit between float32 and a 4-bit copy
    stages = ref.w8a8_stages(m, fam.stage_plan(m))
    assert stages
    got = {}
    for bits in (8, 4):
        q = ref.Quant(tuple(stages), bits)
        q.bounds = ref.calibrate(
            lambda _x, _t, quant=None, calib=None: dec(
                p32, torch.float32, quant, calib), [(x, t)], stages)
        got[bits] = float((dec(p32, torch.float32, q).double() - a)
                          .abs().mean())
    assert 0 < got[8] < got[4]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_reference_matches_the_program_in_float64(name):
    """The reference's equations are the program's: its model in float64
    on the same weights, strictly loaded (the positional encoding is
    float32 in both); the training forward where the family has one, else
    the decode."""
    from boosting_nerv_torch.models import build_model

    cfg = _tiny_pe(FAMILIES[name]())
    m = cfg["model"]
    fam = harness.family(m["model"])
    p = {k: v.double() for k, v in inputs.make_weights(m, SEED, "cpu").items()}
    model = build_model(drivers.port_config(cfg), seed=None, device="cpu")
    model.load_state_dict(p, strict=True)
    model.double()
    t = torch.tensor([0.25, 0.75])
    with torch.no_grad():
        if hasattr(fam, "forward"):
            img = inputs.make_clip(2, 240, 240, SEED, "cpu").double() / 255
            want = model(img, t)
            got = fam.forward(img, t, p, m)
        else:
            want = model(t)
            got = fam.decode(None, t, p, m)
    assert (got - want).abs().max() < 1e-5


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_counts_match_the_flop_counter(name):
    """``counts.decoder_layers`` (and, where the family trains, the
    encoder's) hold every multiply-add that torch's FLOP counter finds in
    the reference's decode (forward) of one frame: the convs, the linears
    and the attention's two products."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = FAMILIES[name]()
    m = cfg["model"]
    fam = harness.family(m["model"])
    p = inputs.make_weights(m, SEED, "cpu")
    x = fam.frame_inputs(m, 1, SEED, "cpu")
    t = torch.tensor([0.25])
    with torch.no_grad(), FlopCounterMode(display=False) as flops:
        fam.decode(x, t, p, m)
    assert flops.get_total_flops() == 2 * sum(
        layer.macs for layer in counts.decoder_layers(cfg))
    if hasattr(fam, "forward"):
        img = inputs.make_clip(1, 240, 240, SEED, "cpu").float() / 255
        with torch.no_grad(), FlopCounterMode(display=False) as flops:
            fam.forward(img, t, p, m)
        assert 3 * flops.get_total_flops() == counts.train_flops(cfg, 1)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert len(files) > 20
    bad = [(f, n) for f in files for n in _imports(f)
           if n.split(".")[0] in harness.FORBIDDEN]
    assert bad == []


def test_the_reference_imports_nothing_of_the_program():
    """No reference file, each family's included, imports the program,
    JAX or the JAX package: by its own imports, and by what loading every
    family leaves loaded in a fresh process."""
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    families = {os.path.basename(f)[:-3] for f in files} - {
        "__init__", "models", "train"}
    assert families == {"hnerv_boost", "nerv_boost", "enerv_boost"}
    bad = [(f, n) for f in files for n in _imports(f)
           if n.split(".")[0] == "boosting_nerv_torch"]
    assert bad == []
    probe = ("import sys\n"
             "from bench_h100 import harness\n"
             f"for name in {sorted(families)!r}:\n"
             "    harness.family(name)\n"
             "print(sorted({k.split('.')[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=small.ROOT,
                         capture_output=True, text=True, timeout=120)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "bench_h100" in loaded
    assert loaded.isdisjoint({"boosting_nerv_torch", *harness.FORBIDDEN})


NAMELESS = ("drivers.py", "counts.py", "inputs.py", "harness.py",
            "control.py")


@pytest.mark.parametrize("name", NAMELESS)
def test_the_harness_names_no_family(name):
    """The family is found by the configuration's ``model``, through its
    file: the generator, the counts, the inputs, the lookup and the
    controls name no family and compare nothing with ``["model"]``."""
    src = open(os.path.join(BENCH, name)).read()
    assert re.findall(r"\w*NeRV\w*", src) == []
    branches = [node.lineno for node in ast.walk(ast.parse(src))
                if isinstance(node, ast.Compare) and any(
                    isinstance(sub, ast.Subscript)
                    and isinstance(sub.slice, ast.Constant)
                    and sub.slice.value == "model"
                    for side in (node.left, *node.comparators)
                    for sub in ast.walk(side))]
    assert branches == []


def test_an_unknown_family_stops_with_its_path():
    cfg = small.config("nerv_boost_10m_uvg1080p")
    cfg["model"]["model"] = "Tiny_Family"
    want = os.path.join(BENCH, "reference", "tiny_family.py")
    with pytest.raises(SystemExit, match=re.escape(want)):
        harness.family("Tiny_Family")
    with pytest.raises(SystemExit, match=re.escape(want)):
        drivers.DecodeCell(cfg, small.mix("seek_bf16"), SEED, "cpu")
    with pytest.raises(SystemExit, match=re.escape(want)):
        inputs.make_weights(cfg["model"], SEED, "cpu")
    assert harness.family("NeRV_Boost").HEAD_K == 1


@pytest.mark.parametrize("change,missing", [
    ({"loss": "L2"}, "loss 'L2'"),
    ({"optim_type": "Adam"}, "optim_type 'Adam'"),
    ({"lr_type": "hybrid_0.1_1_0.1"}, "lr_type 'hybrid'"),
    ({"model": "NeRV_Boost"}, "no training forward"),
])
def test_the_trainer_refuses_what_the_reference_lacks(change, missing):
    cfg = small.config("hnerv_boost_3m_uvg1080p")
    model = change.pop("model", None)
    if model:
        cfg = small.config("nerv_boost_10m_uvg1080p")
    cfg["train"].update(change)
    with pytest.raises(ValueError, match=re.escape(missing)):
        drivers.TrainCell(cfg, small.mix("train"), SEED, "cpu")


def test_spec_names_its_files():
    b = small.bench()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert name.match(c["name"])
        assert harness.load_json(os.path.join(small.ROOT, c["file"]))[
            "name"] == c["name"]
    for w in b["workloads"]:
        assert name.match(w["name"]) and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))
        mine = harness.metrics_of(b, w, False)
        assert {"setup_s"} < {m["name"] for m in mine}
        assert harness.metrics_of(b, w, True)
    for m in b["end_to_end"] + b["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for m in b["per_layer"]:
        assert m["moves"] in e2e


def _ctx(kind="decode", **run):
    cfg = harness.load_json(os.path.join(
        BENCH, "configs", "nerv_boost_10m_uvg1080p.json"))
    mix = harness.load_json(os.path.join(BENCH, "traffic", "seek_bf16.json"))
    trace = Trace(busy_s=1.0, launches=2010,
                  span_s={"fused_conv_rsft": 0.5, "fused_upconv_rsft": 0.25})
    base = {"units": 10, "window_s": 4.0, "on_card": True, "setup_s": 9.0}
    return harness.Ctx("w", cfg, mix, run={**base, **run},
                       latencies_s=[0.01 * (i + 1) for i in range(100)],
                       trace=trace)


def test_readers():
    ctx = _ctx()
    assert readers.rate(ctx) == pytest.approx(2.5)
    assert readers.device_idle(ctx) == pytest.approx(75.0)
    assert readers.launches_per(ctx) == pytest.approx(201.0)
    assert readers.busy_ms(ctx) == pytest.approx(100.0)
    assert readers.p95_ms(ctx) == pytest.approx(950.5)
    least = sum(ms for _, ms, _ in counts.tail_bounds(ctx.config, "bf16"))
    assert readers.planar_roofline(ctx, ("fused_conv_rsft",
                                         "fused_upconv_rsft")) == \
        pytest.approx(100 * least / 1e3 * 10 / 0.75)
    assert 0 < readers.decode_mfu(ctx) < 100
    # nothing to read: no trace, or a run off the card
    for c in (_ctx(on_card=False), harness.Ctx("w", ctx.config, ctx.mix,
                                               run=ctx.run)):
        assert readers.device_idle(c) is None
        assert readers.decode_mfu(c) is None
    assert readers.planar_roofline(ctx, ("conv_tile",)) is None
    metrics = harness.read_metrics([{"name": "device_idle.seek",
                                     "unit": "%"}], ctx)
    assert metrics == {"device_idle.seek": {"value": 75.0, "unit": "%"}}


def test_judge():
    ok, checks, failed = harness.judge({"a": 1.0, "b": 3.0},
                                       {"a": 2.0, "b": 2.0})
    assert (ok, failed) == (False, 1)
    assert list(checks) == ["a", "b"] and checks["b"]["limit"] == 2.0
    assert harness.judge({"a": math.nan}, {"a": 1.0})[0] is False
