#!/usr/bin/env python3
"""Smoke run of the PyTorch port (boosting_nerv_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or one line per shape):

1. requires CUDA (exits non-zero before anything else without it) and
   prints the card's name and power limit as nvidia-smi reports them;
2. builds the hand-written kernels from ``boosting_nerv_torch/ops/csrc``;
3. builds HNeRV-Boost at the UVG-1080p serving config of bench.py with
   seeded random weights, encodes one synthetic 1080x1920 frame, and builds
   the bf16 serving decode and the W8A8 one (calibrated on that frame at
   t in {0.01, 0.25, 0.5, 0.75, 1.0}, margin 1.05, as bench.py does);
4. holds each kernel wrapper against its plain PyTorch version on the card
   at every tail stage shape of both decodes (bf16: stages 2-7; W8A8:
   stage 4's bf16 launch with int8-code output, stages 5-7 in int8) and at
   one small ragged shape each: max abs error within 2e-2 * max(|plain|,
   1), int8 codes compared after dequantising with 1/inv; prints the share
   of codes that differ; times both with CUDA events;
5. the bf16 slice: serves 8 frame indices through ``build_serving_decode``;
   checks the frames (shape, finite, [0, 1], max abs error <= 1e-2 against
   the fp32 plain decode with TF32 off) and the launch counts; times the
   decode (encoder excluded) with the kernels and with the plain stages;
6. the W8A8 slice: checks that stages 5-7 serve int8 and receive int8
   codes, serves the 8 indices, checks the frames (shape, finite, [0, 1],
   max abs error <= 2e-2 against the same decode on the plain stage
   versions, PSNR >= 35 dB against the bf16 kernel decode at t = 0.37, as
   bench.py gates it) and the launch counts; times it against the bf16
   decode in turns (bf16, W8A8, W8A8, bf16).

The launch counts are set to 0 just before each slice's frames and read
just after.  The line before the last is a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}.  Any failed phase
exits non-zero without printing either.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 8
STAGE_TOL = 2e-2    # x max(|plain|, 1): bf16 storage on both sides
SLICE_TOL = 1e-2    # max abs vs the fp32 decode (JAX's bf16 decode: 2.6e-3)
W8A8_TOL = 2e-2     # max abs of the W8A8 decode vs its plain stage versions
PSNR_GATE = 35.0    # W8A8 vs bf16 at the held index, bench.py:206-213
T_HOLD = 0.37
CALIB_TS = (0.01, 0.25, 0.5, 0.75, 1.0)
PLANAR = "boosting_nerv_tpu/ops/pallas/planar.py"
KERNELS = {  # wrapper: (source, replaces)
    "fused_upconv_rsft": ("boosting_nerv_torch/ops/csrc/stage_conv.cu",
                          f"{PLANAR}:1308"),
    "fused_conv_rsft": ("boosting_nerv_torch/ops/csrc/stage_conv.cu",
                        f"{PLANAR}:1541"),
    "fused_upconv_rsft_i8": ("boosting_nerv_torch/ops/csrc/stage_conv_i8.cu",
                             f"{PLANAR}:1308 (W8A8 prep {PLANAR}:707)"),
    "fused_conv_rsft_i8": ("boosting_nerv_torch/ops/csrc/stage_conv_i8.cu",
                           f"{PLANAR}:1541 (W8A8 prep {PLANAR}:673)"),
}
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
# tensor-core operations/s of the kernels' operand types
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12}


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


def bound(name, args, kw, out):
    """(least ms the card could take for one call, "bytes" or
    "operations"): each input and weight read once and the output written
    once at the HBM rate, against the convolutions' multiply-adds at the
    tensor-core peak of the operand type."""
    x, w = args[0], args[1]
    _, h, wd, c_in = x.shape
    cout, c = w.conv_w.shape[0], w.w0.shape[0]
    hf, wf = (2 * h, 2 * wd) if name.startswith("fused_upconv") else (h, wd)
    ops = 2 * 9 * (h * wd * c_in * cout + 2 * hf * wf * c * c
                   + (hf * wf * c * 3 if kw.get("head") else 0))
    nbytes = sum(t.numel() * t.element_size() for t in
                 (x, out, args[2], *vars(w).values(), kw.get("out_inv"))
                 if t is not None)
    t_ops = ops / PEAK_OPS_S["int8" if name.endswith("_i8") else "bf16"]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rnd(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
            * scale).to(dtype)


def rnd_codes(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def ragged_i8(gen, c_in, c, up, head):
    """W8A8 weights of a small stage from random weights and bounds."""
    from boosting_nerv_torch.ops.kernels import planar

    def conv(cin, cout):
        m = torch.nn.Conv2d(cin, cout, 3, device="cuda").requires_grad_(False)
        b = (9 * cin) ** -0.5
        m.weight.uniform_(-b, b, generator=gen)
        m.bias.uniform_(-b, b, generator=gen)
        return m

    bounds = {k: torch.rand((n,), generator=gen, device="cuda") + 0.5
              for k, n in (("x", c_in), ("t0", c), ("t1", c), ("h", c))}
    return planar.StageWeightsI8.from_oihw(
        conv(c_in, 4 * c if up else c), conv(c, c), conv(c, c),
        conv(c, 3) if head else None, bounds=bounds)


def stage_cases(decode, decode_i8, gen):
    """(label, wrapper, args, kwargs) for every tail stage of the bf16
    serving decode and for stage 4 (bf16, int8-code output) and the int8
    stages of the W8A8 one, each with its own weights and the SFT vectors of
    t = 0.5, plus one small ragged stage of each wrapper with random
    weights."""
    from boosting_nerv_torch.ops.kernels import planar

    t_embed = decode.time_embed(torch.tensor([0.5], device="cuda"))
    cases = []
    zc = set(decode_i8.w8a8_zc)
    w8_tail = [st for st in decode_i8.tail
               if st.index in zc or st.out_inv is not None]
    for tag, st in [("", st) for st in decode.tail] + [
            (" w8a8", st) for st in w8_tail]:
        x = (rnd_codes(gen, *st.in_shape) if tag and st.index in zc
             else rnd(gen, *st.in_shape))
        kw = {"head": True} if st.head else {}
        if st.out_inv is not None:
            kw["out_inv"] = st.out_inv
        cases.append((f"stage {st.index}{tag}", st.kernel,
                      (x, st.weights, st.sft(t_embed)), kw))

    c_in, c, h, w = 6, 5, 9, 50   # width 50: not a multiple of the tile
    sft = (torch.rand((4, c), generator=gen, device="cuda") - 0.5) * 0.6
    up = planar.StageWeights(
        rnd(gen, 4 * c, 3, 3, c_in, scale=0.2), rnd(gen, 4 * c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1))
    st1 = planar.StageWeights(
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
        rnd(gen, 3, 3, 3, c, scale=0.2), rnd(gen, 3, scale=0.1))
    up8, st8 = ragged_i8(gen, c_in, c, True, False), ragged_i8(
        gen, c, c, False, True)
    up_args = (rnd(gen, 1, h, w, c_in), up, sft)
    up8_args = (rnd(gen, 1, h, w, c_in), up8, sft)
    cases += [
        ("ragged", "fused_upconv_rsft", up_args,
         {"out_inv": out_inv(planar.fused_upconv_rsft_plain, up_args)}),
        ("ragged", "fused_conv_rsft", (rnd(gen, 1, 2 * h, 2 * w, c), st1,
                                       sft), {"head": True}),
        ("ragged", "fused_upconv_rsft_i8", up8_args,
         {"out_inv": out_inv(planar.fused_upconv_rsft_i8_plain, up8_args)}),
        ("ragged", "fused_conv_rsft_i8",
         (rnd_codes(gen, 1, 2 * h, 2 * w, c), st8, sft), {"head": True}),
    ]
    return cases


def out_inv(plain, args):
    """The int8-output multiplier of a stage as calibration would set it:
    127 / (1.05 max|out|) per channel of its plain output."""
    from boosting_nerv_torch.ops.kernels import quant

    bound = plain(*args).float().abs().amax(dim=(0, 1, 2)) * 1.05
    return quant.inv_from_bound(bound).cuda()


def check_kernels(decode, decode_i8, gen, device_line):
    """Phase 4: kernel vs plain at every tail shape; per-kernel summaries
    (errors over all shapes; times and bounds summed over one frame's
    stages of the decode that serves them)."""
    from boosting_nerv_torch.ops.kernels import planar

    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by": "operations",
                   "library_ms": None} for k in KERNELS}
    for label, name, args, kw in stage_cases(decode, decode_i8, gen):
        kernel = getattr(planar, name)
        plain = getattr(planar, name + "_plain")
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        codes = ""
        g, wnt = got.float(), want.float()
        if got.dtype == torch.int8:  # dequantise the codes with 1/inv
            inv = kw["out_inv"]
            scale = torch.where(inv > 0, 1 / inv, torch.zeros_like(inv))
            codes = (f" codes_differ "
                     f"{(got != want).float().mean().item():.3e}")
            g, wnt = g * scale, wnt * scale
        err = (g - wnt).abs().max().item()
        tol = STAGE_TOL * max(wnt.abs().max().item(), 1.0)
        ms = cuda_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=2, warmup=1)
        b_ms, b_by = bound(name, args, kw, got)
        x = args[0]
        print(f"kernel {name} {label} in {tuple(x.shape)} {x.dtype} out "
              f"{tuple(got.shape)} {got.dtype}: max_abs_err {err:.6g} (tol "
              f"{tol:.4g}){codes} ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by}) [{device_line}]", flush=True)
        if not (err <= tol):
            raise SmokeFailure(f"{name} {label}: error {err} > {tol}")
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        # per-frame sums: the bf16 kernels over the bf16 decode's stages,
        # the int8 ones over the W8A8 decode's
        if label.startswith("stage") and (name.endswith("_i8")
                                          or "w8a8" not in label):
            s["ms"] += ms
            s["plain_ms"] += plain_ms
            s["bound_ms"] += b_ms
            if b_by == "bytes":
                s["bound_by"] = "bytes"
    return summary


def serve(decode, embed, ts):
    """One slice's frames, with the launch counts set to 0 just before and
    read just after."""
    from boosting_nerv_torch.ops.kernels import planar

    planar.reset_launch_counts()
    outs = [decode(embed, t) for t in ts]
    torch.cuda.synchronize()
    launches = dict(planar.LAUNCHES)
    want = {k: decode.launches_per_frame.get(k, 0) * len(ts)
            for k in launches}
    if launches != want or not any(want.values()):
        raise SmokeFailure(f"launches {launches} for {len(ts)} frames, "
                           f"expected {want}")
    for out in outs:
        if tuple(out.shape) != (1, 1080, 1920, 3):
            raise SmokeFailure(f"frame shape {tuple(out.shape)}")
        o = out.float()
        if not bool(torch.isfinite(o).all()):
            raise SmokeFailure("non-finite frame")
        if o.min().item() < 0.0 or o.max().item() > 1.0:
            raise SmokeFailure(f"frame outside [0, 1]: {o.min().item()} .. "
                               f"{o.max().item()}")
    return outs, launches


def turns(first, second, embed, ts):
    """ms/frame of two decodes timed in turns first, second, second, first
    (each turn one region over all frames): (mean, turns) of each."""
    def frames(dec):
        return lambda: [dec(embed, t) for t in ts]

    a1 = cuda_ms(frames(first), iters=1, warmup=1)
    b1 = cuda_ms(frames(second), iters=1, warmup=1)
    b2 = cuda_ms(frames(second), iters=1, warmup=0)
    a2 = cuda_ms(frames(first), iters=1, warmup=0)
    n = len(ts)
    return ((a1 + a2) / 2 / n, (a1 / n, a2 / n)), \
        ((b1 + b2) / 2 / n, (b1 / n, b2 / n))


def run_slice(model, decode, plain_decode, embed, ts, device_line):
    """Phase 5: the bf16 slice; returns its launch counts."""
    outs, launches = serve(decode, embed, ts)
    print(f"slice bf16 launches over {N_FRAMES} frames: {launches} "
          f"(per frame {decode.launches_per_frame})", flush=True)
    err = 0.0
    for t, out in zip(ts, outs):
        with torch.no_grad():
            ref = model.decode(embed, t)
        err = max(err, (out.float() - ref).abs().max().item())
    print(f"slice bf16 {N_FRAMES} frames (1, 1080, 1920, 3) finite in "
          f"[0, 1]: max_abs_err vs fp32 plain decode {err:.6g} (tol "
          f"{SLICE_TOL})", flush=True)
    if not (err <= SLICE_TOL):
        raise SmokeFailure(f"slice error {err} > {SLICE_TOL}")
    (p_ms, p_t), (k_ms, k_t) = turns(plain_decode, decode, embed, ts)
    print(f"decode ms/frame (UVG-1080p, bf16, encoder excluded): kernels "
          f"{k_ms:.3f} ({k_t[0]:.3f}, {k_t[1]:.3f}), plain stages "
          f"{p_ms:.3f} ({p_t[0]:.3f}, {p_t[1]:.3f}) [{device_line}]",
          flush=True)
    return launches


def run_w8a8_slice(decode, decode_i8, plain_i8, embed, ts, device_line):
    """Phase 6: the W8A8 slice; returns its launch counts."""
    if not (decode_i8.w8a8_stages == decode_i8.w8a8_zc == [5, 6, 7]):
        raise SmokeFailure(f"W8A8 stages {decode_i8.w8a8_stages}, "
                           f"zero-convert {decode_i8.w8a8_zc}: expected "
                           "[5, 6, 7] for both")
    outs, launches = serve(decode_i8, embed, ts)
    print(f"slice w8a8 stages {decode_i8.w8a8_stages} (int8 codes in: "
          f"{decode_i8.w8a8_zc}) launches over {N_FRAMES} frames: {launches} "
          f"(per frame {decode_i8.launches_per_frame})", flush=True)
    err = max((out.float() - plain_i8(embed, t).float()).abs().max().item()
              for t, out in zip(ts, outs))
    t_hold = torch.tensor([T_HOLD], device="cuda")
    mse = (decode_i8(embed, t_hold).float()
           - decode(embed, t_hold).float()).pow(2).mean().item()
    psnr = 99.0 if mse <= 1e-12 else -10.0 * math.log10(mse)
    print(f"slice w8a8 {N_FRAMES} frames (1, 1080, 1920, 3) finite in "
          f"[0, 1]: max_abs_err vs plain-stage W8A8 decode {err:.6g} (tol "
          f"{W8A8_TOL}); PSNR vs bf16 kernel decode at t={T_HOLD}: "
          f"{psnr:.3f} dB (gate {PSNR_GATE})", flush=True)
    if not (err <= W8A8_TOL):
        raise SmokeFailure(f"W8A8 slice error {err} > {W8A8_TOL}")
    if not (psnr >= PSNR_GATE):
        raise SmokeFailure(f"W8A8 PSNR {psnr} dB < {PSNR_GATE}")
    (b_ms, b_t), (q_ms, q_t) = turns(decode, decode_i8, embed, ts)
    print(f"decode ms/frame (UVG-1080p, encoder excluded): w8a8 {q_ms:.3f} "
          f"({q_t[0]:.3f}, {q_t[1]:.3f}), bf16 {b_ms:.3f} ({b_t[0]:.3f}, "
          f"{b_t[1]:.3f}) [{device_line}]", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.ops.kernels import _build
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode

    device_line = card()
    print(f"card: {device_line}", flush=True)
    # every float32 reference in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path()})", flush=True)

    cfg = bench_config()
    model = build_model(cfg, seed=0).eval()
    frame = np.random.default_rng(0).uniform(
        size=(1, 1080, 1920, 3)).astype(np.float32)
    with torch.no_grad():
        embed = model.encode(torch.from_numpy(frame).cuda())
    ts = [torch.tensor([v], dtype=torch.float32, device="cuda")
          for v in np.linspace(0.01, 1.0, N_FRAMES)]
    calib = [(embed, torch.tensor([v], device="cuda")) for v in CALIB_TS]
    t0 = time.perf_counter()
    decode = build_serving_decode(cfg, model)
    plain_decode = build_serving_decode(cfg, model, plain=True)
    decode_i8 = build_serving_decode(cfg, model, w8a8_calib=calib)
    plain_i8 = build_serving_decode(cfg, model, w8a8_calib=calib, plain=True)
    print(f"decodes built (W8A8 calibrated twice): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = check_kernels(decode, decode_i8, gen, device_line)
    launches = run_slice(model, decode, plain_decode, embed, ts, device_line)
    launches_i8 = run_w8a8_slice(decode, decode_i8, plain_i8, embed, ts,
                                 device_line)

    leaked = [m for m in ("jax", "flax", "boosting_nerv_tpu")
              if m in sys.modules]
    if leaked:
        raise SmokeFailure(f"imported {leaked}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name] + launches_i8[name], **summary[name]}
        for name, (src, rep) in KERNELS.items()]}))
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
