"""Spans, per-phase wall-clock timing (``PhaseTimer``, a copy of
``gdr_tpu/utils/timing.py``'s) and the counter registry.

``span(name)`` marks a stage of the program in a ``torch.profiler`` (or
``emit_nvtx``) trace: while a profiler records, it opens a
``record_function`` range, which lands in the same trace as the device
events and on their clock; while none records, it returns one shared
no-op context, at the cost of one check.  The serving path's spans are
``gdr.retrieve`` and, inside it, ``gdr.encode``, ``gdr.decode.init``,
``gdr.decode.step`` (holding ``gdr.decode.forward`` and
``gdr.beam.select``), ``gdr.decode.sync``, ``gdr.decode.finalize``,
``gdr.query`` and ``gdr.rerank``, ``gdr.moe`` (args: rows and the
experts a row, k) around each routed-expert layer (``models/t5.py``,
``models/deepseek.py``), and ``gdr.kda`` (args: rows, and the step's
position or ``prefill``) around each KDA layer's kernel call
(``models/kimi_linear.py``); ``gdr.encode``'s args give the prefill's rows;
``PhaseTimer`` phases open ``gdr.eval.<phase>``.  Where the decode replays CUDA graphs
(``ops/decode_graphs.py``), each replayed piece is a ``gdr.decode.replay``
range (args: the piece's first position) in place of the ranges its
captured code opened.

The counter registry holds every host counter by name: the kernel
wrappers' launches (each kernel module declares its own, :func:`declare`),
``host_syncs`` (the retrieve path's reads of a device value), the decode's
CUDA graph pieces captured and replayed (``graph_captures``,
``graph_replays``), its eager CUDA decodes (``eager_decodes``) and the
beam rows whose KDA state a decode call read and wrote
(``kda_state_rows``, ``kernels/kda.py``).  Every
increment goes through :func:`count` and :func:`counts` reads them all; a
graph capture puts back (:func:`restore`) what it read before.  The routed
experts' routing counters live on the device (``kernels/experts.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()

_COUNTS = dict.fromkeys(("host_syncs", "graph_captures", "graph_replays",
                         "eager_decodes"), 0)


def declare(*names: str) -> tuple[str, ...]:
    """Counters ``names`` in the registry, at 0 where new; returns them."""
    for name in names:
        _COUNTS.setdefault(name, 0)
    return names


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counts() -> dict[str, int]:
    """Every counter of the registry, a copy."""
    return dict(_COUNTS)


def restore(snapshot: dict[str, int]) -> None:
    """Set the counters to ``snapshot`` (what :func:`counts` read)."""
    _COUNTS.update(snapshot)


def span(name: str, args: str | None = None):
    """A context manager that records ``name`` (with ``args``) as a range
    of the trace while a profiler records, and does nothing otherwise."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name, args)


class PhaseTimer:
    """Accumulates wall-clock time per named phase; each phase is also the
    span ``gdr.eval.<name>``."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span("gdr.eval." + name):
                yield
        finally:
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
