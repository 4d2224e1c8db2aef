"""Graceful shutdown on SIGTERM / SIGINT (a copy of
``gdr_tpu/utils/preemption.py``): a signal sets a flag, the training loop
finishes its step, writes a resume point and returns."""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Install with ``with``; poll ``should_stop`` between steps."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self._stop = threading.Event()
        self._prev = {}
        self._signals = tuple(signals)

    def __enter__(self) -> "PreemptionGuard":
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _handler(self, signum, frame) -> None:
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def request_stop(self) -> None:
        """Programmatic preemption (tests, external watchers)."""
        self._stop.set()
