"""The device trace of a traced window, reduced to what the per-layer
metrics read: every device operation (kernels, copies, sets) with its
start and length, the union of their intervals (busy time), the kernel
launch count, and the device's idle gaps labelled by the host operation
that was running in them.

``traced(fn)`` runs ``fn`` under ``torch.profiler`` with CPU and CUDA
activity, inside one ``record_function`` span that marks the window, and
returns a :class:`Trace`.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

WINDOW = "gdrbench.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    ops: list[tuple[str, float, float]]          # device (name, start s, dur s)
    idle_by_host: dict[str, float] = field(default_factory=dict)

    def device_time(self, pick) -> float:
        """Summed device seconds of the operations whose name ``pick``
        accepts."""
        return sum(d for n, _, d in self.ops if pick(n))

    def breakdown(self, top: int = 10) -> dict:
        by: dict[str, float] = {}
        for n, _, d in self.ops:
            k = short_name(n)
            by[k] = by.get(k, 0.0) + d
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its template arguments, parameters and
    return type."""
    n = name.split("(")[0]
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    n = "".join(out).strip()
    n = re.sub(r"^(void|float|int)\s+", "", n)
    return n[:120] or name[:120]


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of the trace."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and getattr(e, "is_user_annotation", lambda: False)():
            continue
        start = e.start_ns()
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


def traced(fn) -> Trace:
    """Run ``fn`` once under the profiler and reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return reduce(_events(prof))


def reduce(events) -> Trace:
    """The :class:`Trace` of ``events`` (name, is_device, start_ns,
    end_ns) inside the window span."""
    win = [e for e in events if e[0] == WINDOW and not e[1]]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0][2], win[0][3]
    dev = sorted((e for e in events if e[1] and e[3] > w0 and e[2] < w1),
                 key=lambda e: e[2])
    host = sorted((e for e in events if not e[1] and e[0] != WINDOW
                   and e[3] > w0 and e[2] < w1), key=lambda e: e[2])
    ops, kernels = [], 0
    merged: list[list[int]] = []
    for name, _, s, t in dev:
        s, t = max(s, w0), min(t, w1)
        ops.append((name, s * 1e-9, (t - s) * 1e-9))
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    gaps, prev = [], w0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    starts = [e[2] for e in host]
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        label = _host_at((g0 + g1) // 2, host, starts)
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                 kernels=kernels, ops=ops, idle_by_host=idle)


def _host_at(t: int, host, starts, scan: int = 256) -> str:
    """The innermost host operation running at ``t``: the latest-started
    one that has not ended."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - scan, -1), -1):
        if host[j][3] >= t:
            return host[j][0]
    return "host code outside profiled operations"

