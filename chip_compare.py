#!/usr/bin/env python3
"""Same-call comparison of two trees of the port on one NVIDIA GPU.

    python3 chip_compare.py PARENT_DIR [--no-decodes]

PARENT_DIR holds another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists.  The script runs itself as a worker four times, in
turns: the parent tree, this tree, this tree, the parent tree.  Each
worker is a fresh process that imports ``boosting_nerv_torch`` from its
tree, so each tree builds its own kernels (into its own build
directory).  A worker builds HNeRV-Boost at chip_smoke.py's UVG-1080p
serving config with seeded random weights and times, with CUDA events:

- the decodes, in ms/frame over 8 frame indices, encoder excluded: v5
  bf16, W8A8 (calibrated as chip_smoke.py does), v3 (``tile_from_h=45``)
  and the hybrid (``fine_from_h=1000``);
- the calls of the Hopper kernel ``conv_sm90.cu``, in ms per call,
  through what both trees have: ``planar.fused_upconv_rsft`` at the v5
  stages 2, 4 and 6; ``tile_conv.conv_tile`` at every call of the v2
  decode (stages 1-7 and the 51 -> 3 head); and chains of
  ``conv_sm90.cuda_conv`` launches for the v5
  stride-1 stages 3, 5 and 7 + head (conv + sin, the ResBlockSFT pair,
  the head) and for the ResBlockSFT pair alone at 540x960x61 and
  1080x1920x51.

``--no-decodes`` times the calls only (a quicker look at a kernel change).

Every call's output is summed, so that the two trees' results can be
compared too.  The script prints, beside the card's name and power limit,
one line per item (each tree's two turns, their means, the change against
the parent, the output sums) and each tree's ptxas register report of
``conv_sm90.cu``.  It exits non-zero without CUDA or when a worker fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

N_FRAMES = 8


def worker(tree: str, decodes: bool = True) -> dict:
    """Times every item with the package of ``tree``; returns
    {"items": {name: [ms, output sum]}, "registers": [conv_sm90.cu's
    instances], "spill_bytes": n}."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.ops.kernels import (_build, conv_sm90, planar,
                                                 tile_conv)
    from boosting_nerv_torch.runtime.fast_decode import (
        build_fast_decode_v2, build_fast_decode_v3, build_fast_decode_v5,
        build_serving_decode)
    from chip_smoke import CALIB_TS, bench_config, cuda_ms

    assert os.path.dirname(os.path.abspath(_build.__file__)) == os.path.join(
        os.path.abspath(tree), "boosting_nerv_torch", "ops", "kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = _build.load_library()
    conv = conv_sm90.cuda_conv(lib)
    cfg = bench_config()
    model = build_model(cfg, seed=0).eval()
    frame = np.random.default_rng(0).uniform(
        size=(1, 1080, 1920, 3)).astype(np.float32)
    items = {}
    with torch.no_grad():
        embed = model.encode(torch.from_numpy(frame).cuda())
        ts = [torch.tensor([v], dtype=torch.float32, device="cuda")
              for v in np.linspace(0.01, 1.0, N_FRAMES)]
        calib = [(embed, torch.tensor([v], device="cuda")) for v in CALIB_TS]
        serving = build_serving_decode(cfg, model)
        decodes = {} if not decodes else {
            "decode v5 bf16": serving,
            "decode w8a8": build_serving_decode(cfg, model,
                                                w8a8_calib=calib),
            "decode v3": build_fast_decode_v3(cfg, model, tile_from_h=45),
            "decode hybrid": build_fast_decode_v5(cfg, model,
                                                  fine_from_h=1000)}
        for name, dec in decodes.items():
            ms = cuda_ms(lambda: [dec(embed, t) for t in ts], iters=2,
                         warmup=1) / N_FRAMES
            items[name] = [ms, float(dec(embed, ts[3]).float().sum())]

        def rsft(y, w0, b0, w1, b1, sft):
            t = conv(y, w0, b0, y.shape, act="gelu",
                     in_affine=(sft[0], sft[1]), out_affine=(sft[2], sft[3]))
            return conv(t, w1, b1, y.shape, residual=y)

        def conv_rsft(x, ws, sft, head):
            y = conv(x, ws.conv_w, ws.conv_b,
                     x.shape[:3] + (ws.w0.shape[0],), act="sin")
            out = rsft(y, ws.w0, ws.b0, ws.w1, ws.b1, sft)
            if head:
                out = conv(out, ws.head_w, ws.head_b, x.shape[:3] + (3,),
                           act="outimg")
            return out

        gen = torch.Generator(device="cuda").manual_seed(0)

        def rnd(*shape):
            return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                    ).to(torch.bfloat16)

        dec = serving
        t_embed = dec.time_embed(torch.tensor([0.5], device="cuda"))
        calls = {}
        for st in dec.tail:
            x, sft, ws = rnd(*st.in_shape), st.sft(t_embed), st.weights
            if st.strd == 2:
                calls[f"fused_upconv_rsft stage {st.index}"] = (
                    lambda x=x, ws=ws, sft=sft:
                    planar.fused_upconv_rsft(x, ws, sft))
            else:
                calls[f"conv_rsft chain stage {st.index}"
                      + (" + head" if st.head else "")] = (
                    lambda x=x, ws=ws, sft=sft, hd=st.head:
                    conv_rsft(x, ws, sft, hd))
            if st.index in (5, 7):
                y = rnd(*st.in_shape)
                calls[f"rsft pair {tuple(y.shape)}"] = (
                    lambda y=y, ws=ws, sft=sft:
                    rsft(y, ws.w0, ws.b0, ws.w1, ws.b1, sft))
        v2 = build_fast_decode_v2(cfg, model, tile_from_h=45).fine
        convs = [(f"stage {st.index}", st.conv_w, st.conv_b,
                  (st.out_hw[0] // st.strd, st.out_hw[1] // st.strd))
                 for st in v2.stages if st.upconv is None]
        convs.append(("head", v2.head_w, v2.head_b, v2.stages[-1].out_hw))
        for label, wt, b, (h, w) in convs:
            x = rnd(1, h, w, wt.shape[3])
            calls[f"conv_tile v2 {label}"] = (
                lambda x=x, wt=wt, b=b:
                tile_conv.conv_tile(x, wt, b, k=wt.shape[1]))
        for name, fn in calls.items():
            items[name] = [cuda_ms(fn), float(fn().float().sum())]
    log = open(_build.library_path() + ".log").read()
    sec = next((t for t in log.split("\n# ") if
                t.lstrip("# ").startswith("conv_sm90.cu")), "")
    regs = re.findall(r"Used (\d+) registers", sec)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        sec)
    return {"items": items, "registers": sorted(map(int, regs)),
            "spill_bytes": sum(int(a) + int(b) for a, b in spills)}


def run_worker(tree: str, decodes: bool) -> dict:
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--worker", tree]
                         + ([] if decodes else ["--no-decodes"]),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"chip_compare: worker for {tree} failed "
                         f"({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(prog="chip_compare.py")
    ap.add_argument("parent", nargs="?", help="the other tree")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--no-decodes", action="store_true",
                    help="time the kernel calls only")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, not args.no_decodes)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    if not args.parent or not os.path.isdir(
            os.path.join(args.parent, "boosting_nerv_torch")):
        print("chip_compare: PARENT_DIR must hold boosting_nerv_torch/",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    order = [("parent", args.parent), ("change", here), ("change", here),
             ("parent", args.parent)]
    runs = [(tag, run_worker(tree, not args.no_decodes))
            for tag, tree in order]
    for tag, r in (runs[0], runs[1]):
        print(f"ptxas conv_sm90.cu ({tag}): registers {r['registers']}, "
              f"{r['spill_bytes']} spill bytes", flush=True)
    for name in runs[0][1]["items"]:
        par = [r["items"][name] for tag, r in runs if tag == "parent"]
        chg = [r["items"][name] for tag, r in runs if tag == "change"]
        pm = sum(v[0] for v in par) / 2
        cm = sum(v[0] for v in chg) / 2
        print(f"compare {name}: parent {pm:.4f} ms ({par[0][0]:.4f}, "
              f"{par[1][0]:.4f}), change {cm:.4f} ms ({chg[0][0]:.4f}, "
              f"{chg[1][0]:.4f}), {100 * (cm - pm) / pm:+.2f}%; output sum "
              f"parent {par[0][1]:.6g} change {chg[0][1]:.6g} [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
