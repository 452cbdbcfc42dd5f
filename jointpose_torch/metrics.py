"""Metrics (counterpart of ``jointpose/metrics.py:MetricLogger``): a JSONL
event stream, ``<workdir>/metrics.jsonl``, with the reference's records
(``step``, ``time`` and the keyword metrics, scalars as floats), echoed to
stdout.  The profiler hook is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "metrics.jsonl")
        self._file = open(self.path, "a", buffering=1)

    def log(self, step: int, **metrics: Any) -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._file.write(json.dumps(record) + "\n")
        scalars = ", ".join(
            f"{k}={float(v):.4g}" for k, v in metrics.items() if hasattr(v, "__float__")
        )
        print(f"[step {step}] {scalars}", flush=True)

    def close(self) -> None:
        self._file.close()
