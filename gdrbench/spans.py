"""The program's spans in a traced window: which ``gdr.`` span
(``gdr_tpu_torch/utils/timing.py::span``) launched each device operation,
how long each span held the host, and in which span the device sat idle.

A device operation belongs to the innermost ``gdr.`` span that holds the
runtime call that launched it (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...), matched by the trace's
correlation id; one whose launch is not in the trace is left under
``UNMATCHED``, one launched outside every span under ``OUTSIDE``.  An idle
gap of the device belongs to the innermost span open at its midpoint.
Spans, launches and gaps are all on the profiler's clock.

``events(prof)`` reads a finished ``torch.profiler.profile``; its
``[e[:4] for e in ...]`` is the event list of ``trace.reduce``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from gdrbench.trace import WINDOW

PREFIX = "gdr."
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
OUTSIDE = "outside gdr.retrieve"
UNMATCHED = "no launch in the trace"


@dataclass
class Spans:
    device_by_span: dict[str, float] = field(default_factory=dict)
    host_by_span: dict[str, dict] = field(default_factory=dict)
    idle_by_span: dict[str, float] = field(default_factory=dict)


def events(prof) -> list[tuple]:
    """(name, is_device, start_ns, end_ns, correlation id) of every event
    of the trace, device-side user annotations left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and getattr(e, "is_user_annotation", lambda: False)():
            continue
        start = e.start_ns()
        out.append((e.name(), dev, start, start + e.duration_ns(),
                    e.correlation_id()))
    return out


class _Nest:
    """Properly nested ranges (name, start, end): each one's parent, and
    the innermost range holding a time."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
        self.starts = [r[1] for r in self.ranges]
        self.parent: list[int | None] = []
        stack: list[int] = []
        for i, (_, s, t) in enumerate(self.ranges):
            while stack and not (self.ranges[stack[-1]][1] <= s
                                 and t <= self.ranges[stack[-1]][2]):
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def at(self, t: int) -> int | None:
        """The innermost range holding ``t``: the latest-started one, or
        the first of its ancestors that has not ended by ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        j = i if i >= 0 else None
        while j is not None and self.ranges[j][2] < t:
            j = self.parent[j]
        return j

    def name_at(self, t: int) -> str:
        j = self.at(t)
        return OUTSIDE if j is None else self.ranges[j][0]


def attribute(evs) -> Spans:
    """The :class:`Spans` of ``evs`` (as :func:`events` gives them) inside
    the window span."""
    win = [e for e in evs if e[0] == WINDOW and not e[1]]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0][2], win[0][3]
    nest = _Nest([(e[0], max(e[2], w0), min(e[3], w1)) for e in evs
                  if not e[1] and e[0].startswith(PREFIX)
                  and e[3] > w0 and e[2] < w1])
    launch_at = {e[4]: e[2] for e in evs
                 if not e[1] and e[4] and e[0].startswith(LAUNCH_CALLS)}
    out = Spans()
    dev = sorted(((max(e[2], w0), min(e[3], w1), e[4]) for e in evs
                  if e[1] and e[3] > w0 and e[2] < w1))
    for s, t, corr in dev:
        key = (nest.name_at(launch_at[corr]) if corr in launch_at
               else UNMATCHED)
        out.device_by_span[key] = out.device_by_span.get(key, 0.0) \
            + (t - s) * 1e-9
    for i, (name, s, t) in enumerate(nest.ranges):
        rec = out.host_by_span.setdefault(
            name, {"n": 0, "total_s": 0.0, "self_s": 0.0})
        rec["n"] += 1
        rec["total_s"] += (t - s) * 1e-9
        rec["self_s"] += (t - s) * 1e-9
        p = nest.parent[i]
        if p is not None:
            out.host_by_span[nest.ranges[p][0]]["self_s"] -= (t - s) * 1e-9
    prev = w0
    for s, t, _ in dev + [(w1, w1, 0)]:
        if s > prev:
            key = nest.name_at((prev + s) // 2)
            out.idle_by_span[key] = out.idle_by_span.get(key, 0.0) \
                + (s - prev) * 1e-9
        prev = max(prev, t)
    return out
