"""The v5 decode's front as one CUDA graph a frame
(``runtime/fast_decode.py``'s ``PrefixGraph``) and the cached PE bases
(``ops/pe.py``'s ``pe_bases``).

On the CPU: the cached bases are the float64-rounded construction's bits
and a second encoding builds no host tensor; the v5 decode of each family
takes the eager front (no graph, no replay counted) and serves the frame
that the uncached PE gives, and its graph branch, with the front run
eagerly in the graph's place and its spans held as in a capture, serves
the same bits, with ``decode.prefix`` a leaf.

Marked ``card`` (skipped without a CUDA device): the graph decode against
the eager decode built through the same code with the graph forced off,
bitwise, over 16 frames in order and in a random order with no
synchronise between frames, for the three benchmark configurations
(HNeRV-Boost W8A8, NeRV-Boost bf16, E-NeRV-Boost 15M bf16, whose stage 2
takes the K loop once a frame) and a tiny E-NeRV-Boost; and a freed graph
decode gives its memory back.  Run them on the card (this file
imports no JAX, so without the JAX conftest):

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_prefix_graph.py -q
"""

import gc
import json
import math
import os

import numpy as np
import pytest
import torch

from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.ops import pe
from boosting_nerv_torch.ops.kernels import LAUNCHES
from boosting_nerv_torch.ops.kernels.conv_sm90 import KLOOP_LAUNCHES
from boosting_nerv_torch.runtime import fast_decode
from boosting_nerv_torch.runtime.fast_decode import (GRAPH,
                                                     build_fast_decode_v5)
from boosting_nerv_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed="pe_1.25_4", fc_dim=16, fc_hw="2_4", dec_strds=[2, 2, 2],
            dec_blks=[1, 1, 2], ks="0_1_5",
            conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
            sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
            block_dim=16, enc_strds=[2, 2, 2], enc_dim="8_4")
# each family at toy size, with the precision its benchmark cell serves
FAMILIES = {"HNeRV_Boost": ({}, True), "NeRV_Boost": ({}, False),
            "ENeRV_Boost": ({"fc_dim": 8}, False)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph runs on the card)")
    return "cuda"


def _frames(cfg: BoostConfig, n: int, device, seed: int = 0):
    """(embed, t) pairs: embed [1, h, w, C] for HNeRV-Boost (None for the
    index-only families), t [1] at (i + 1) / n."""
    gen = torch.Generator().manual_seed(seed)
    shape = None
    if cfg.model == "HNeRV_Boost":
        fh, fw = (int(v) for v in cfg.fc_hw.split("_"))
        shape = (1, fh, fw, int(cfg.enc_dim.split("_")[1]))
    return [(None if shape is None
             else torch.randn(shape, generator=gen).to(device),
             torch.tensor([(i + 1) / n], dtype=torch.float32, device=device))
            for i in range(n)]


def _decode(cfg, model, frames, w8a8, **kw):
    return build_fast_decode_v5(cfg, model, frames[:4] if w8a8 else None,
                                **kw)


def test_pe_bases_are_the_float64_rounded_bits():
    specs = [("pe_1.25_80", "pi"),   # the recipes' (every family's)
             ("pe_1.25_4", "pi"),    # the toy configs'
             ("pe_2_16", "1.0")]
    for spec, lfreq in specs:
        cfg = pe.PEConfig.from_string(spec, lfreq)
        powers = torch.tensor([cfg.lbase ** i for i in range(cfg.levels)],
                              dtype=torch.float64)
        want = powers.to(torch.float32) * cfg.lfreq
        got = pe.pe_bases(cfg, torch.device("cpu"))
        assert got.dtype == torch.float32
        assert torch.equal(got, want), spec
        pos = torch.tensor([0.125, 1.0])
        vals = pos[:, None] * want
        assert torch.equal(pe.position_encoding(pos, cfg),
                           torch.cat([torch.sin(vals), torch.cos(vals)], -1))


def test_second_encoding_builds_no_host_tensor(monkeypatch):
    calls = []
    make = torch.tensor

    def counted(*args, **kw):
        calls.append(args)
        return make(*args, **kw)

    cfg = pe.PEConfig(lbase=1.3125, levels=7, lfreq=math.e)  # no other test
    pos = make([0.5])
    monkeypatch.setattr(torch, "tensor", counted)
    first = pe.position_encoding(pos, cfg)
    assert len(calls) == 1
    second = pe.position_encoding(pos, cfg)
    assert len(calls) == 1
    assert torch.equal(first, second)


@pytest.mark.parametrize("model", list(FAMILIES))
def test_cpu_decode_runs_the_eager_front(model, monkeypatch):
    kw, w8a8 = FAMILIES[model]
    cfg = BoostConfig(model=model, **{**TINY, **kw})
    net = build_model(cfg, seed=0, device="cpu").eval()
    frames = _frames(cfg, 3, "cpu")
    before = LAUNCHES[GRAPH]
    dec = _decode(cfg, net, frames, w8a8, planar_from_h=1)
    assert dec.graph is None and GRAPH not in dec.launches_per_frame
    got = [dec(*f) for f in frames]
    assert LAUNCHES[GRAPH] == before

    # the frames of the uncached PE (a host tensor of powers every call)
    def uncached(cfg, device):
        powers = torch.tensor([cfg.lbase ** i for i in range(cfg.levels)],
                              dtype=torch.float64, device=device)
        return powers.to(torch.float32) * cfg.lfreq

    with monkeypatch.context() as m:
        m.setattr(pe, "pe_bases", uncached)
        old = _decode(cfg, net, frames, w8a8, planar_from_h=1)
        for f, out in zip(frames, got):
            assert torch.equal(out, old(*f))

    # the graph branch, with the front run eagerly in the graph's place
    # and its spans held, as in a capture: decode.prefix is then a leaf
    def stand_in(front, device, takes_embed):
        def run(embed, t):
            with tracing.held():
                return front(embed, t)
        return run

    monkeypatch.setattr(fast_decode, "_prefix_graph", stand_in)
    dec = _decode(cfg, net, frames, w8a8, planar_from_h=1)
    assert dec.launches_per_frame[GRAPH] == 1
    tracing.reset()
    with monkeypatch.context() as m:  # spans on, no profiler start-up
        m.setattr(tracing._profiler, "_is_profiler_enabled", True)
        outs = [dec(*f) for f in frames]
    spans = tracing.records()
    tracing.reset()
    for out, want in zip(outs, got):
        assert torch.equal(out, want)
    names = {sp.name for sp in spans}
    assert {"decode.pe", "decode.stem", "decode.sft"}.isdisjoint(names)
    assert {"decode", "decode.prefix", "decode.tail",
            "decode.kernel"} <= names
    prefix = [sp.id for sp in spans if sp.name == "decode.prefix"]
    assert len(prefix) == len(frames)
    assert not any(sp.parent in prefix for sp in spans)


def _bench_config(name: str) -> BoostConfig:
    path = os.path.join(ROOT, "bench_h100", "configs", name + ".json")
    with open(path) as f:
        c = json.load(f)
    clip = c["clip"]
    return BoostConfig(**c["model"],
                       crop_list=f"{clip['height']}_{clip['width']}")


@pytest.mark.card
def test_graph_decode_is_the_eager_decode_on_card(card, monkeypatch):
    # (config, W8A8, build options, K-loop launches a frame)
    cases = [(_bench_config("hnerv_boost_3m_uvg1080p"), True, {}, 0),
             (_bench_config("nerv_boost_10m_uvg1080p"), False, {}, 0),
             (_bench_config("enerv_boost_15m_uvg1080p"), False, {}, 1),
             (BoostConfig(model="ENeRV_Boost", **{**TINY, "fc_dim": 8}),
              False, {"planar_from_h": 1}, 0)]
    order = np.random.default_rng(5).permutation(16).tolist()
    for cfg, w8a8, kw, kloop in cases:
        model = build_model(cfg, seed=0, device=card).eval()
        frames = _frames(cfg, 16, card, seed=1)
        with monkeypatch.context() as m:
            m.setattr(fast_decode, "_prefix_graph", lambda *a: None)
            eager = _decode(cfg, model, frames, w8a8, **kw)
        assert eager.graph is None
        want = [eager(*f) for f in frames]
        dec = _decode(cfg, model, frames, w8a8, **kw)
        assert dec.launches_per_frame[GRAPH] == 1
        assert dec.launches_per_frame.get(KLOOP_LAUNCHES, 0) == kloop
        before = LAUNCHES[GRAPH], LAUNCHES[KLOOP_LAUNCHES]
        for idx in (list(range(16)), order):
            got = [dec(*frames[i]) for i in idx]   # no synchronise between
            torch.cuda.synchronize()
            for i, out in zip(idx, got):
                assert torch.equal(out, want[i]), (cfg.model, i)
        assert (LAUNCHES[GRAPH] - before[0],
                LAUNCHES[KLOOP_LAUNCHES] - before[1]) == (32, 32 * kloop)
        del model, eager, dec, want, got


@pytest.mark.card
def test_freed_graph_decode_gives_its_memory_back(card):
    cfg = BoostConfig(model="NeRV_Boost", **TINY)
    model = build_model(cfg, seed=0, device=card).eval()
    frames = _frames(cfg, 4, card)

    def serve():
        dec = build_fast_decode_v5(cfg, model, planar_from_h=1)
        outs = [dec(*f) for f in frames]
        torch.cuda.synchronize()
        return dec, outs

    serve()   # once a process: the PE bases, the capture stream's workspace
    gc.collect()
    held = torch.cuda.memory_allocated()
    dec, outs = serve()
    assert dec.graph.graph is not None
    assert torch.cuda.memory_allocated() > held
    del dec, outs
    gc.collect()
    assert torch.cuda.memory_allocated() == held
