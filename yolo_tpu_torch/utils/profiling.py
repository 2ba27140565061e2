"""Training metrics log (counterpart of ``MetricsLogger`` in
``yolo_tpu/utils/profiling.py``): one JSON record per line, the same
records."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL scalar log: ``log(step, **scalars)`` writes
    {"step", "time", scalar: float, ...} and, with ``echo``, prints
    them."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, **scalars):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            body = " ".join(f"{k}={v:.4g}" for k, v in scalars.items())
            print(f"[step {step}] {body}")

    def close(self):
        if self._f:
            self._f.close()
