"""Per-phase wall-clock timing (a copy of ``PhaseTimer`` from
``gdr_tpu/utils/timing.py``).

The reference's ``profile_trace`` is a ``jax.profiler`` hook and has no
copy here: ``torch.profiler`` serves on the card (``chip_smoke.py
profile``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Iterator

import torch


def _cuda_devices(obj) -> set:
    """The CUDA devices of the tensors in ``obj`` (a tensor, a dataclass,
    a mapping or a sequence of them)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in obj))
    return set()


class PhaseTimer:
    """Accumulates wall-clock time per named phase.  ``block_on``: results
    whose CUDA work the span must cover; their devices are synchronised
    before the clock stops."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(block_on):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict[str, float]:
        out = {}
        for k, total in self.totals.items():
            out[f"{k}_total_s"] = total
            out[f"{k}_mean_ms"] = 1e3 * total / max(self.counts[k], 1)
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
