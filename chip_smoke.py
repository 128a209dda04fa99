#!/usr/bin/env python3
"""Smoke run of the PyTorch port (boosting_nerv_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or one line per shape):

1. requires CUDA (exits non-zero before anything else without it) and
   prints the card's name and power limit as nvidia-smi reports them;
2. builds the hand-written kernels from ``boosting_nerv_torch/ops/csrc``;
3. holds each kernel wrapper against its plain PyTorch version on the card,
   in bf16, at every decoder-tail stage shape of the UVG-1080p serving
   config and at one small ragged shape: max abs error within
   2e-2 * max(|plain|, 1); times both with CUDA events;
4. the slice: builds HNeRV-Boost at that config with seeded random weights,
   encodes one synthetic 1080x1920 frame, and serves 8 frame indices
   through ``build_serving_decode``; checks the frames (shape, finite,
   [0, 1], max abs error <= 1e-2 against the fp32 plain decode with TF32
   off) and that every tail stage launched its kernel; times the decode
   (encoder excluded) with the kernels and with the plain stage versions.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failed phase exits
non-zero without printing either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 8
STAGE_TOL = 2e-2    # x max(|plain|, 1): bf16 storage on both sides
SLICE_TOL = 1e-2    # max abs vs the fp32 decode (JAX's bf16 decode: 2.6e-3)
REPLACES = {
    "fused_upconv_rsft": "boosting_nerv_tpu/ops/pallas/planar.py:1308",
    "fused_conv_rsft": "boosting_nerv_tpu/ops/pallas/planar.py:1541",
}
SOURCE = "boosting_nerv_torch/ops/csrc/stage_conv.cu"


class SmokeFailure(Exception):
    pass


def bench_config():
    """The UVG-1080p serving config of bench.py (HNeRV-Boost, ~3M params)."""
    from boosting_nerv_torch.config import BoostConfig, resolve_sizes

    cfg = BoostConfig(
        model="HNeRV_Boost", embed="pe_1.25_80", enc_strds=[5, 3, 2, 2, 2],
        enc_dim="64_16", dec_strds=[5, 3, 2, 2, 2], dec_blks=[1, 1, 2, 2, 2],
        ks="0_1_5", reduce=1.2, lower_width=12, modelsize=2.8,
        conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
        sft_block="res_sft", ch_t=32)
    return resolve_sizes(cfg, final_size=1920 * 1080, full_data_length=120)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_cases(decode, gen):
    """(label, wrapper, plain, args, kwargs) for every tail stage of the
    serving decode, with its own weights and the SFT vectors of t = 0.5,
    plus one small ragged stage with random weights."""
    from boosting_nerv_torch.ops.kernels import planar

    t_embed = decode.time_embed(torch.tensor([0.5], device="cuda"))
    cases = []
    for st in decode.tail:
        x = (torch.rand(st.in_shape, generator=gen, device="cuda") * 2 - 1
             ).to(torch.bfloat16)
        name = "fused_upconv_rsft" if st.strd == 2 else "fused_conv_rsft"
        kw = {} if st.strd == 2 else {"head": st.head}
        cases.append((f"stage {st.index}", name, (x, st.weights,
                                                  st.sft(t_embed)), kw))

    def rnd(*shape, scale):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * scale).to(torch.bfloat16)

    c_in, c, h, w = 6, 5, 9, 50   # width 50: not a multiple of the tile
    sft = (torch.rand((4, c), generator=gen, device="cuda") - 0.5) * 0.6
    up = planar.StageWeights(
        rnd(4 * c, 3, 3, c_in, scale=0.2), rnd(4 * c, scale=0.1),
        rnd(c, 3, 3, c, scale=0.2), rnd(c, scale=0.1),
        rnd(c, 3, 3, c, scale=0.2), rnd(c, scale=0.1))
    st1 = planar.StageWeights(
        rnd(c, 3, 3, c, scale=0.2), rnd(c, scale=0.1),
        rnd(c, 3, 3, c, scale=0.2), rnd(c, scale=0.1),
        rnd(c, 3, 3, c, scale=0.2), rnd(c, scale=0.1),
        rnd(3, 3, 3, c, scale=0.2), rnd(3, scale=0.1))
    cases.append(("ragged", "fused_upconv_rsft",
                  (rnd(1, h, w, c_in, scale=1.0), up, sft), {}))
    cases.append(("ragged", "fused_conv_rsft",
                  (rnd(1, 2 * h, 2 * w, c, scale=1.0), st1, sft),
                  {"head": True}))
    return cases


def check_kernels(decode, gen, device_line):
    """Phase 3: kernel vs plain at every tail shape; per-kernel summaries
    (errors over all shapes, times summed over one frame's stages)."""
    from boosting_nerv_torch.ops.kernels import planar

    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in REPLACES}
    for label, name, args, kw in stage_cases(decode, gen):
        kernel = getattr(planar, name)
        plain = getattr(planar, name + "_plain")
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = STAGE_TOL * max(want.float().abs().max().item(), 1.0)
        ms = cuda_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw))
        x = args[0]
        print(f"kernel {name} {label} in {tuple(x.shape)} out "
              f"{tuple(got.shape)}: max_abs_err {err:.6g} (tol {tol:.4g}) "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} [{device_line}]",
              flush=True)
        if not (err <= tol):
            raise SmokeFailure(f"{name} {label}: error {err} > {tol}")
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if label != "ragged":
            s["ms"] += ms
            s["plain_ms"] += plain_ms
    return summary


def run_slice(cfg, model, decode, plain_decode, device_line):
    """Phase 4: serve N_FRAMES indices through the kernel path; returns the
    launch counts of that run."""
    from boosting_nerv_torch.ops.kernels import planar

    frame = np.random.default_rng(0).uniform(
        size=(1, 1080, 1920, 3)).astype(np.float32)
    with torch.no_grad():
        embed = model.encode(torch.from_numpy(frame).cuda())
    ts = [torch.tensor([v], dtype=torch.float32, device="cuda")
          for v in np.linspace(0.01, 1.0, N_FRAMES)]

    planar.reset_launch_counts()
    outs = [decode(embed, t) for t in ts]
    torch.cuda.synchronize()
    launches = dict(planar.LAUNCHES)

    for name, per_frame in decode.launches_per_frame.items():
        if launches[name] != per_frame * N_FRAMES or per_frame == 0:
            raise SmokeFailure(f"{name}: {launches[name]} launches for "
                               f"{N_FRAMES} frames, expected "
                               f"{per_frame} per frame")
    print(f"slice launches over {N_FRAMES} frames: {launches} "
          f"(per frame {decode.launches_per_frame})", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = 0.0
    for t, out in zip(ts, outs):
        if tuple(out.shape) != (1, 1080, 1920, 3):
            raise SmokeFailure(f"frame shape {tuple(out.shape)}")
        o = out.float()
        if not bool(torch.isfinite(o).all()):
            raise SmokeFailure("non-finite frame")
        if o.min().item() < 0.0 or o.max().item() > 1.0:
            raise SmokeFailure(f"frame outside [0, 1]: {o.min().item()} .. "
                               f"{o.max().item()}")
        with torch.no_grad():
            ref = model.decode(embed, t)
        err = max(err, (o - ref).abs().max().item())
    print(f"slice {N_FRAMES} frames (1, 1080, 1920, 3) finite in [0, 1]: "
          f"max_abs_err vs fp32 plain decode {err:.6g} (tol {SLICE_TOL})",
          flush=True)
    if not (err <= SLICE_TOL):
        raise SmokeFailure(f"slice error {err} > {SLICE_TOL}")

    def frames(dec):
        return lambda: [dec(embed, t) for t in ts]

    # turns: plain, kernel, kernel, plain
    p1 = cuda_ms(frames(plain_decode), iters=1, warmup=1)
    k1 = cuda_ms(frames(decode), iters=1, warmup=1)
    k2 = cuda_ms(frames(decode), iters=1, warmup=0)
    p2 = cuda_ms(frames(plain_decode), iters=1, warmup=0)
    k_ms, p_ms = (k1 + k2) / 2 / N_FRAMES, (p1 + p2) / 2 / N_FRAMES
    print(f"decode ms/frame (UVG-1080p, bf16, encoder excluded): kernels "
          f"{k_ms:.3f} ({k1 / N_FRAMES:.3f}, {k2 / N_FRAMES:.3f}), plain "
          f"stages {p_ms:.3f} ({p1 / N_FRAMES:.3f}, {p2 / N_FRAMES:.3f}) "
          f"[{device_line}]", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.ops.kernels import _build, planar
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode

    device_line = card()
    print(f"card: {device_line}", flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path()})", flush=True)

    cfg = bench_config()
    model = build_model(cfg, seed=0, device="cuda").eval()
    decode = build_serving_decode(cfg, model)
    plain_decode = build_serving_decode(
        cfg, model, stage_fns=(planar.fused_upconv_rsft_plain,
                               planar.fused_conv_rsft_plain))
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = check_kernels(decode, gen, device_line)
    launches = run_slice(cfg, model, decode, plain_decode, device_line)

    leaked = [m for m in ("jax", "flax", "boosting_nerv_tpu")
              if m in sys.modules]
    if leaked:
        raise SmokeFailure(f"imported {leaked}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         **summary[name]} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
