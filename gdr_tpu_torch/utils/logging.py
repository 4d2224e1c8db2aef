"""Metric logging to an append-only JSONL file (the counterpart of
``gdr_tpu/utils/logging.py``'s always-on sink; its optional wandb and
TensorBoard sinks are not ported)."""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str = "run"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)

    def log(self, metrics: dict[str, Any], step: int) -> None:
        row = {"step": int(step), "time": time.time()}
        row.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._fh.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._fh.close()


class NullLogger:
    """A :class:`MetricLogger` that writes nothing: the ranks of a mesh
    other than rank 0."""

    def log(self, metrics: dict[str, Any], step: int) -> None:
        pass

    def close(self) -> None:
        pass
