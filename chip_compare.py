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
  bf16, W8A8 (calibrated as chip_smoke.py does), v3 and v2
  (``tile_from_h=45``), the hybrid (``fine_from_h=1000``) and v1
  (``pallas_from_h=512``);
- the calls of the Hopper kernel ``conv_sm90.cu``, in ms per call,
  through what both trees have: ``planar.fused_upconv_rsft`` at the v5
  stages 2, 4 and 6; ``tile_conv.conv_tile`` at every call of the v2
  decode (stages 1-7 and the 51 -> 3 head); and chains of
  ``conv_sm90.cuda_conv`` launches for the v5
  stride-1 stages 3, 5 and 7 + head (conv + sin, the ResBlockSFT pair,
  the head) and for the ResBlockSFT pair alone at 540x960x61 and
  1080x1920x51;
- the fine-grid wrappers at every call of a frame of their decode:
  ``tile_conv.conv_tile_v3`` (v3 stages 1-7 and the head),
  ``tile_conv.resblock_sft_tile_v3`` (v3) and
  ``tile_conv.resblock_sft_tile`` (v2), each at stages 0-7, whatever
  kernel each tree runs them on;
- the W8A8 stage calls, in ms per call: ``planar.fused_conv_rsft_i8`` at
  stages 5 and 7 + head and ``planar.fused_upconv_rsft_i8`` at stage 6 of
  the W8A8 decode, int8 codes in, as that decode calls them (each tree's
  own kernel: the stage kernel before the int8 form of ``conv_sm90.cu``);
- the v1 decode's ``fused_sft.resblock_sft_chw`` calls (stage 6 with
  ``input_sin``, stage 7), its ``conv_chw.conv3x3_act_chw`` (stage 7) and
  ``conv_chw.head_conv_chw`` (the head) calls, ``planar.rsft_planar`` and
  ``planar.conv_planar`` (sin at stage 7, outimg at the head) at the
  planar form of stage 7 (C 51, Hc 540, wc_real 960, Wd 1024) and the
  planar phase's stage 7 + head (``conv_planar`` with sin,
  ``rsft_planar``, ``conv_planar`` with outimg), in ms per call (each
  tree's own kernels).

``--no-decodes`` times the calls only (a quicker look at a kernel change).

Every call's output is summed, so that the two trees' results can be
compared too.  The script prints, beside the card's name and power limit,
one line per item (each tree's two turns, their means, the change against
the parent, the output sums), each tree's ptxas register report of
``conv_sm90.cu`` and whether each of its kernel instances has the same
SASS (``cuobjdump -sass``, addresses aside) in both trees.  It exits
non-zero without CUDA or when a worker fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

N_FRAMES = 8


def sass_digests(lib_path: str) -> dict:
    """{"N P F R": digest of its SASS instructions} of conv_sm90.cu's kernel
    instances in the library (``cuobjdump -sass``; each instruction's
    address dropped)."""
    tool = next(c for c in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "cuobjdump"), shutil.which("cuobjdump"))
        if c and os.path.exists(c))
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, key, lines = {}, None, []
    for line in text.splitlines() + ["Function : end"]:
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            if key is not None:
                out[key] = hashlib.sha256("\n".join(lines).encode()
                                          ).hexdigest()[:16]
            name = m.group(1)
            k = re.search(r"conv_sm90_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi"
                          r"(\d+)E", name)
            key = (" ".join(k.groups()) if k and re.search(
                r"_\d+_conv_sm90_cu_", name) else None)
            lines = []
        elif key is not None:
            i = re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?;)", line)
            if i:
                lines.append(i.group(1))
    return out


def worker(tree: str, decodes: bool = True) -> dict:
    """Times every item with the package of ``tree``; returns
    {"items": {name: [ms, output sum]}, "registers": [conv_sm90.cu's
    instances], "spill_bytes": n, "sass": sass_digests}."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.ops.kernels import (_build, conv_chw, conv_sm90,
                                                 fused_sft, planar, tile_conv)
    from boosting_nerv_torch.runtime.fast_decode import (
        build_fast_decode, build_fast_decode_v2, build_fast_decode_v3,
        build_fast_decode_v5, build_serving_decode)
    from chip_smoke import CALIB_TS, PLANAR_WD, bench_config, cuda_ms, hwio

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
        w8a8 = build_serving_decode(cfg, model, w8a8_calib=calib)
        decodes = {} if not decodes else {
            "decode v5 bf16": serving,
            "decode w8a8": w8a8,
            "decode v3": build_fast_decode_v3(cfg, model, tile_from_h=45),
            "decode v2": build_fast_decode_v2(cfg, model, tile_from_h=45),
            "decode hybrid": build_fast_decode_v5(cfg, model,
                                                  fine_from_h=1000),
            "decode v1": build_fast_decode(cfg, model, 512)}
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
        t8 = w8a8.time_embed(torch.tensor([0.5], device="cuda"))
        for st in w8a8.tail:
            if not st.kernel.endswith("_i8"):
                continue
            x = torch.randint(-127, 128, st.in_shape, generator=gen,
                              device="cuda", dtype=torch.int8)
            a = (x, st.weights, st.sft(t8))
            if st.kernel == "fused_upconv_rsft_i8":
                fn = (lambda a=a, oi=st.out_inv:
                      planar.fused_upconv_rsft_i8(*a, oi))
            else:
                fn = (lambda a=a, hd=st.head, oi=st.out_inv:
                      planar.fused_conv_rsft_i8(*a, hd, oi))
            calls[f"{st.kernel} stage {st.index}"
                  + (" + head" if st.head else "")] = fn
        v2 = build_fast_decode_v2(cfg, model, tile_from_h=45)
        v3 = build_fast_decode_v3(cfg, model, tile_from_h=45)
        for tag, dec in (("v2", v2), ("v3", v3)):
            fine = dec.fine
            tconv = (tile_conv.conv_tile_v3 if fine.v3
                     else tile_conv.conv_tile)
            act = {"act": "sin"} if fine.v3 else {}
            convs = [(f"stage {st.index}", st.conv_w, st.conv_b,
                      (st.out_hw[0] // st.strd, st.out_hw[1] // st.strd),
                      act) for st in fine.stages if st.upconv is None]
            convs.append(("head", fine.head_w, fine.head_b,
                          fine.stages[-1].out_hw,
                          {"act": "outimg"} if fine.v3 else {}))
            for label, wt, b, (h, w), kw in convs:
                x = rnd(1, h, w, wt.shape[3])
                calls[f"{tconv.__name__} {tag} {label}"] = (
                    lambda x=x, wt=wt, b=b, kw=kw, f=tconv:
                    f(x, wt, b, k=wt.shape[1], **kw))
            rsft_fn = (tile_conv.resblock_sft_tile_v3 if fine.v3
                       else tile_conv.resblock_sft_tile)
            te = dec.time_embed(torch.tensor([0.5], device="cuda"))
            for st in fine.stages:
                y = rnd(1, *st.out_hw, st.rsft[0].shape[0])
                calls[f"{rsft_fn.__name__} {tag} stage {st.index}"] = (
                    lambda y=y, rw=st.rsft, sft=st.sft(te), f=rsft_fn:
                    f(y, *rw, sft))
        v1 = build_fast_decode(cfg, model, 512)
        t1 = v1.time_embed(torch.tensor([0.5], device="cuda"))
        for st in v1.chw.stages:
            y, s_in = rnd(1, *st.out_hw, st.rsft[0].shape[0]), (
                st.upconv is not None)
            calls[f"resblock_sft_chw v1 stage {st.index}"
                  + (" input_sin" if s_in else "")] = (
                lambda y=y, rw=st.rsft, sft=st.sft(t1), s_in=s_in:
                fused_sft.resblock_sft_chw(y, *rw, sft, input_sin=s_in))
        st7 = v1.chw.stages[-1]
        c, (hf, wf) = st7.rsft[0].shape[0], st7.out_hw
        xp = torch.nn.functional.pad(planar.to_planar(rnd(c, hf, wf)),
                                     (0, PLANAR_WD - wf // 2))
        w0, b0, w1, b1 = st7.rsft
        sft7, real = st7.sft(t1), {"hc_real": hf // 2, "wc_real": wf // 2}

        def rsft_planar(x):
            return planar.rsft_planar(x, hwio(w0), b0, hwio(w1), b1, sft7,
                                      c=c, **real)

        def planar_phase():
            x = planar.conv_planar(xp, hwio(st7.conv_w), st7.conv_b, c_in=c,
                                   c_out=c, wc_real=wf // 2, act="sin")
            return planar.conv_planar(
                rsft_planar(x), hwio(v1.chw.head_w), v1.chw.head_b, c_in=c,
                c_out=3, wc_real=wf // 2, act="outimg")

        calls["rsft_planar planar stage 7"] = lambda: rsft_planar(xp)
        calls["planar phase stage 7 + head"] = planar_phase
        for label, cw, cb, act, fn in (
                ("stage 7", st7.conv_w, st7.conv_b, "sin",
                 conv_chw.conv3x3_act_chw),
                ("head", v1.chw.head_w, v1.chw.head_b, "outimg",
                 conv_chw.head_conv_chw)):
            x = rnd(1, hf, wf, c)
            calls[f"{fn.__name__} v1 {label}"] = (
                lambda x=x, cw=cw, cb=cb, fn=fn: fn(x, cw, cb))
            calls[f"conv_planar planar {label}"] = (
                lambda w=hwio(cw), cb=cb, co=cw.shape[0], act=act:
                planar.conv_planar(xp, w, cb, c_in=c, c_out=co,
                                   wc_real=wf // 2, act=act))
        for name, fn in calls.items():
            items[name] = [cuda_ms(fn), float(fn().float().sum())]
    log = open(_build.library_path() + ".log").read()
    sec = next((t for t in log.split("\n# ") if
                t.lstrip("# ").startswith("conv_sm90.cu")), "")
    regs = re.findall(r"Used (\d+) registers", sec)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        sec)
    return {"items": items, "registers": sorted(map(int, regs)),
            "spill_bytes": sum(int(a) + int(b) for a, b in spills),
            "sass": sass_digests(_build.library_path())}


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
    par, chg = runs[0][1]["sass"], runs[1][1]["sass"]
    for key in sorted(set(par) | set(chg)):
        same = "same" if par.get(key) == chg.get(key) else "differs"
        print(f"sass conv_sm90.cu N P F R {key}: parent {par.get(key)}, "
              f"change {chg.get(key)}: {same}", flush=True)
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
