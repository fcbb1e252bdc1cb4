"""Structured JSONL metrics logging.

Counterpart of `nas_3d_unet_tpu/utils/logging.py`: every record is one JSON
line, written to a file and mirrored to stdout, with the same schema (the
caller's fields plus `t`, seconds since the logger was made).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

from ..parallel.mesh import is_main


class MetricsLogger:
    """Only rank 0 writes (with several ranks, metrics are computed from
    the same values, so the others would write duplicates).

    `tb_dir`: optional TensorBoard mirror.  Numeric fields of each record
    become scalars tagged `<event>/<field>`; the step is the record's
    `step` (falling back to `epoch`, then a running record count).
    `torch.utils.tensorboard` is imported only when asked for; without the
    tensorboard package the mirror is a no-op and one warning line says so.
    """

    def __init__(self, path: Optional[str] = None, stdout: bool = True,
                 tb_dir: Optional[str] = None):
        primary = is_main()
        self._file = None
        if path and primary:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a", buffering=1)
        self._stdout = stdout and primary
        self._t0 = time.time()
        self._tb = None
        self._n = 0
        if tb_dir and primary:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tb_dir)
            except ImportError as e:     # no tensorboard package: JSONL only
                print(json.dumps({"event": "warn",
                                  "msg": f"tensorboard mirror disabled: {e}"}),
                      file=sys.stderr)

    def log(self, **record) -> None:
        record.setdefault("t", round(time.time() - self._t0, 3))
        line = json.dumps(record, default=float)
        if self._file:
            self._file.write(line + "\n")
        if self._stdout:
            print(line, file=sys.stdout, flush=True)
        self._n += 1
        if self._tb is not None:
            self._write_tb(record)

    def _write_tb(self, record: dict) -> None:
        prefix = str(record.get("event", "metrics"))
        step = int(record.get("step", record.get("epoch", self._n - 1)))
        for key, val in record.items():
            if key in ("event", "step", "epoch", "t"):
                continue
            try:
                f = float(val)
            except (TypeError, ValueError):
                continue
            self._tb.add_scalar(f"{prefix}/{key}", f, step)
        self._tb.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
