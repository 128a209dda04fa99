"""Host C++ libraries of the port, compiled with g++ at first use.

``build_shared(src, lib)`` compiles one C++ source with ``g++ -O3 -shared
-fPIC -std=c++17`` into ``lib`` unless an up-to-date one is there (built
again when the source is newer).  Concurrent first uses (threads, or
processes sharing the checkout) build once, under a lock file beside the
library; the build lands under a temporary name and is renamed into
place.  A failed build raises: nothing falls back.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")


def _stale(src: str, lib: str) -> bool:
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def build_shared(src: str, lib: str) -> None:
    """Compile ``src`` into the shared library ``lib``; raises
    RuntimeError with the compiler's output on failure."""
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(lib))[0]
    with open(os.path.join(out_dir, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(src, lib):
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            res = subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                                  "-std=c++17", src, "-o", tmp],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed to build {src}:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
