"""Run logging (port of boosting_nerv_tpu/utils/logger.py): the
``rank0.txt`` append-log, the ``args.yaml`` snapshot of the config, the
CSV of results and optional TensorBoard scalars; ``NullLogger`` for the
data-parallel ranks other than rank 0.

It needs no package beyond the standard library: ``args.yaml`` is written
as one ``key: value`` line a field, in a form ``yaml.safe_load`` reads
back to the same dict, and the CSV with the ``csv`` module in pandas'
``DataFrame(row, index=[0]).to_csv`` layout (an empty index header, then
row ``0``).  TensorBoard scalars are written when ``tensorboardX`` is
installed, as in the JAX package.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
from datetime import datetime
from typing import Dict


def _yaml_scalar(v) -> str:
    """A YAML 1.1 flow scalar that ``yaml.safe_load`` reads back as ``v``."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:  # YAML 1.1 reads 1e-05 as a string, 1.0e-05 not
            mant, _, exp = r.partition("e")
            r = f"{mant}.0" + (f"e{exp}" if exp else "")
        return r
    if isinstance(v, str):
        return json.dumps(v)  # a double-quoted YAML scalar
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    raise TypeError(f"no YAML form for {type(v).__name__}")


class RunLogger:
    def __init__(self, outf: str, enable_tb: bool = True):
        self.outf = outf
        os.makedirs(outf, exist_ok=True)
        self.log_path = os.path.join(outf, "rank0.txt")
        self.tb = None
        if enable_tb:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(os.path.join(outf, "tensorboard"))

    def dump_config(self, cfg):
        d = (dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg)
             else dict(cfg))
        with open(os.path.join(self.outf, "args.yaml"), "w") as f:
            for k in sorted(d):
                f.write(f"{k}: {_yaml_scalar(d[k])}\n")

    def print(self, msg: str):
        stamp = datetime.now().strftime("%Y/%m/%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        print(line, flush=True)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")

    def scalar(self, tag: str, value: float, step: int):
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def dump_csv(self, row: Dict, filename: str):
        path = os.path.join(self.outf, filename)
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + list(row))
            w.writerow([0] + list(row.values()))
        print(f"results dumped to {path}", flush=True)


class NullLogger:
    """The logger of a data-parallel rank other than rank 0, which owns the
    logs: it writes nothing."""

    def print(self, msg: str):
        pass

    def scalar(self, tag: str, value: float, step: int):
        pass

    def dump_config(self, cfg):
        pass

    def dump_csv(self, row: Dict, filename: str):
        pass
