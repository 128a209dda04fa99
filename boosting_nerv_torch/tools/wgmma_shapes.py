"""Which wgmma shapes ptxas takes for sm_90a: the N of ``wgmma.mma_async
.sync.aligned.m64nNk32.s32.s8.s8`` (the int8 form of the Hopper conv
kernel, ``ops/csrc/conv_sm90_i8.cu``) and of ``m64nNk16.f32.bf16.bf16``
(its bf16 form), each compiled alone.

    PYTHONPATH=. python3 -m boosting_nerv_torch.tools.wgmma_shapes [N ...]

For each N (default: 8 to 96 in steps of 8) it writes a one-instruction
kernel with both operands from shared-memory descriptors, compiles it
with ``nvcc -cubin`` for ``sm_90a`` into a temporary directory and prints
one line per type and N: "ok", or "rejected" with ptxas's first error
line.  It needs the CUDA toolkit (``nvcc``), not a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

from boosting_nerv_torch.ops.kernels import _build

TYPES = {  # name: (shape suffix, register type, constraint, K, scale args)
    "s8": ("k32.s32.s8.s8", "int", "r", 32, ""),
    "bf16": ("k16.f32.bf16.bf16", "float", "f", 16, ", 1, 1, 0, 0"),
}


def source(kind: str, n: int) -> str:
    """A kernel issuing one m64nN wgmma of ``kind``."""
    suffix, ctype, cons, _, scale = TYPES[kind]
    regs = n // 2
    outs = ", ".join(f'"+{cons}"(d[{i}])' for i in range(regs))
    lst = ", ".join(f"%{i}" for i in range(regs))
    return f"""
#include <stdint.h>
__global__ void probe({ctype}* out, uint64_t a, uint64_t b) {{
  {ctype} d[{regs}] = {{}};
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}{suffix} {{{lst}}}, "
      "%{regs}, %{regs + 1}, p{scale};\\n}}\\n"
      : {outs}
      : "l"(a), "l"(b), "r"(1));
  for (int i = 0; i < {regs}; ++i) out[i] = d[i];
}}
"""


def compile_ok(kind: str, n: int, tmp: str) -> Optional[str]:
    """None if ptxas takes the shape, else its first error line."""
    src = os.path.join(tmp, f"{kind}_{n}.cu")
    with open(src, "w") as f:
        f.write(source(kind, n))
    res = subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, "-cubin", "-o",
         src[:-3] + ".cubin", src], capture_output=True, text=True)
    if res.returncode == 0:
        return None
    lines = [ln for ln in (res.stdout + res.stderr).splitlines()
             if "error" in ln.lower()]
    return lines[0].strip() if lines else f"nvcc exit {res.returncode}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m boosting_nerv_torch.tools.wgmma_shapes",
        description="Compile one wgmma per N and type for sm_90a.")
    ap.add_argument("n", nargs="*", type=int,
                    help="the N to try (default 8, 16, ..., 96)")
    args = ap.parse_args(argv)
    ns: List[int] = args.n or list(range(8, 97, 8))
    with tempfile.TemporaryDirectory() as tmp:
        for kind in TYPES:
            for n in ns:
                err = compile_ok(kind, n, tmp)
                print(f"wgmma m64n{n}{TYPES[kind][0]}: "
                      + ("ok" if err is None else f"rejected ({err})"),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
