"""Logging (counterpart of ``scanobjectnn_tpu/utils/logging.py``): file and
stderr, as the reference's ``log_string`` (pointnet2/train.py:111-114
writes log_train.txt and prints), and the scalar history as JSONL in
place of TensorBoard scalars.  Its files are the JAX ``Logger``'s for the
same calls."""

from __future__ import annotations

import json
import os
import sys
import time

__all__ = ["Logger"]


class Logger:
    """``log`` writes ``log_dir/filename`` (where there is a ``log_dir``)
    and, with ``echo``, prints to stderr."""

    def __init__(self, log_dir: str | None = None, filename: str = "log_train.txt", echo: bool = True):
        self.log_dir = log_dir
        self.echo = echo
        self._fout = None
        self._metrics_path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fout = open(os.path.join(log_dir, filename), "a")
            self._metrics_path = os.path.join(log_dir, "metrics.jsonl")

    def log(self, msg: str) -> None:
        if self._fout is not None:
            self._fout.write(msg + "\n")
            self._fout.flush()
        if self.echo:
            print(msg, file=sys.stderr)

    def scalars(self, step: int, **values) -> None:
        """One record {"step", "time", **values as floats} in
        ``metrics.jsonl``."""
        if self._metrics_path is None:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fout is not None:
            self._fout.close()
            self._fout = None
