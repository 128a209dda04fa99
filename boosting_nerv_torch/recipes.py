"""Run a training recipe of ``scripts/`` on the port, unmodified.

    python -m boosting_nerv_torch.recipes <script.sh> [--dry-run] \\
        [-- <extra flags>]

The recipe is sourced by ``sh`` with a shell function ``python`` defined
first.  That function sends ``python train_nerv_all.py ...`` to
``python3 -m boosting_nerv_torch.train_nerv_all ...`` and
``python train_nerv_compression.py ...`` to
``boosting_nerv_torch.train_nerv_compression``, with the extra flags
(``--device cpu``, say) appended; anything else goes to the real
interpreter.  The recipe's own loops and environment switches
(``BNT_FAST``) run as written, from the current directory (the recipes
read ``./dataset/...`` and write ``output/...``).  ``--dry-run`` prints
each command's argv instead of running it; ``recipe_commands`` returns
them.  Neither a recipe nor a JAX CLI is edited.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shlex
import subprocess
import sys
import tempfile
from typing import List, Sequence, Tuple

CLIS = {"train_nerv_all.py": "boosting_nerv_torch.train_nerv_all",
        "train_nerv_compression.py":
            "boosting_nerv_torch.train_nerv_compression"}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# BNT_RECIPE_LOG set: append each command (its CLI module, then its
# arguments, each ended by NUL) to that file instead of running it
_SHIM = r"""
python() {
  case "${1##*/}" in
    train_nerv_all.py) cli=boosting_nerv_torch.train_nerv_all ;;
    train_nerv_compression.py) cli=boosting_nerv_torch.train_nerv_compression ;;
    *) "$BNT_RECIPE_PYTHON" "$@"; return ;;
  esac
  shift
  if [ -n "$BNT_RECIPE_LOG" ]; then
    printf '%s\0' "$cli" "$@" >> "$BNT_RECIPE_LOG"
    printf '\n' >> "$BNT_RECIPE_LOG"
  else
    "$BNT_RECIPE_PYTHON" -m boosting_nerv_torch.recipes --exec "$cli" "$@"
  fi
}
. "$0"
"""


def _source(path: str, extra: Sequence[str], log: str = "") -> int:
    """Source the recipe ``path`` under the shim; its exit status."""
    env = dict(os.environ, BNT_RECIPE_PYTHON=sys.executable,
               BNT_RECIPE_EXTRA=json.dumps(list(extra)),
               BNT_RECIPE_LOG=log,
               PYTHONPATH=os.pathsep.join(
                   [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]))
    return subprocess.run(["sh", "-c", _SHIM, os.path.abspath(path)],
                          env=env).returncode


def recipe_commands(path: str, extra: Sequence[str] = ()
                    ) -> List[Tuple[str, List[str]]]:
    """(the port's CLI module, its argv with ``extra`` appended) of every
    command the recipe ``path`` runs, in order, none of them run."""
    fd, log = tempfile.mkstemp(suffix=".cmds")
    os.close(fd)
    try:
        rc = _source(path, extra, log)
        if rc:
            raise RuntimeError(f"sh exited {rc} sourcing {path}")
        with open(log, "rb") as f:
            records = f.read().split(b"\0\n")
    finally:
        os.remove(log)
    out = []
    for rec in records:
        if rec:
            cli, *argv = rec.decode().split("\0")
            out.append((cli, argv + list(extra)))
    return out


def _exec(cli: str, argv: List[str]) -> None:
    """Run the port CLI ``cli`` on ``argv`` plus ``BNT_RECIPE_EXTRA``."""
    extra = json.loads(os.environ.get("BNT_RECIPE_EXTRA", "[]"))
    importlib.import_module(cli).main(argv + extra)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--exec"]:
        _exec(argv[1], argv[2:])
        return 0
    extra = []
    if "--" in argv:
        at = argv.index("--")
        argv, extra = argv[:at], argv[at + 1:]
    p = argparse.ArgumentParser(
        prog="python -m boosting_nerv_torch.recipes",
        description="Run a recipe of scripts/ on the port.")
    p.add_argument("script")
    p.add_argument("--dry-run", action="store_true",
                   help="print each command's argv instead of running it")
    args = p.parse_args(argv)
    if not args.dry_run:
        return _source(args.script, extra)
    for cli, cmd in recipe_commands(args.script, extra):
        print(shlex.join([os.path.basename(sys.executable), "-m", cli]
                         + cmd))
    return 0


if __name__ == "__main__":
    sys.exit(main())
