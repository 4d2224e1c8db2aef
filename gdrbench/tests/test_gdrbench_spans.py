"""Device operations and idle gaps put down to the program's spans
(``spans.py``), on a synthetic trace whose every number is known, beside
what ``trace.reduce`` and the serving readers make of the same events;
then on a real CPU trace of the port's spans."""

from __future__ import annotations

import importlib.util

import pytest

from conftest import REPO
from gdrbench import spans, trace

# (name, is_device, start ns, end ns, correlation id); aten::mm carries a
# correlation id of the op sequence, equal to kernel k6's, which has no
# launch in the trace
EVENTS = [
    (trace.WINDOW, False, 0, 1000, 0),
    ("gdr.retrieve", False, 100, 900, 0),
    ("gdr.encode", False, 110, 300, 0),
    ("aten::mm", False, 120, 200, 16),
    ("cudaLaunchKernel", False, 130, 135, 11),
    ("gdr.decode.step", False, 300, 600, 0),
    ("gdr.decode.forward", False, 300, 450, 0),
    ("cuLaunchKernelEx", False, 320, 326, 12),
    ("gdr.beam.select", False, 450, 600, 0),
    ("cudaLaunchKernel", False, 460, 464, 13),
    ("gdr.decode.sync", False, 600, 700, 0),
    ("gdr.rerank", False, 700, 890, 0),
    ("cudaMemcpyAsync", False, 710, 716, 14),
    ("cudaLaunchKernel", False, 950, 955, 15),
    ("void gemm_kernel<float>(float*)", True, 140, 250, 11),
    ("void gdr::gemm_f32_ring<4>(float const*)", True, 330, 500, 12),
    ("at::native::topk_kernel", True, 505, 520, 13),
    ("elementwise_kernel", True, 600, 610, 16),
    ("Memcpy DtoH (Device -> Pageable)", True, 720, 730, 14),
    ("reduce_kernel", True, 960, 980, 15),
]
NS = 1e-9


def _approx(d):
    return {k: pytest.approx(v, abs=1e-15) for k, v in d.items()}


def test_device_ops_go_to_the_span_that_launched_them():
    got = spans.attribute(EVENTS)
    assert got.device_by_span == _approx({
        "gdr.encode": 110 * NS, "gdr.decode.forward": 170 * NS,
        "gdr.beam.select": 15 * NS, "gdr.rerank": 10 * NS,
        spans.OUTSIDE: 20 * NS, spans.UNMATCHED: 10 * NS})


def test_idle_gaps_go_by_span():
    got = spans.attribute(EVENTS)
    assert got.idle_by_span == _approx({
        spans.OUTSIDE: (140 + 20) * NS, "gdr.encode": 80 * NS,
        "gdr.beam.select": (5 + 80) * NS, "gdr.decode.sync": 110 * NS,
        "gdr.rerank": 230 * NS})
    tr = trace.reduce([e[:4] for e in EVENTS])
    assert sum(got.idle_by_span.values()) == pytest.approx(
        tr.window_s - tr.busy_s, abs=1e-15)


def test_host_time_and_self_time_by_span():
    got = spans.attribute(EVENTS).host_by_span
    assert got["gdr.retrieve"] == {"n": 1, "total_s": pytest.approx(800 * NS),
                                   "self_s": pytest.approx(20 * NS)}
    assert got["gdr.decode.step"]["self_s"] == pytest.approx(0, abs=1e-15)
    assert got["gdr.decode.forward"]["total_s"] == pytest.approx(150 * NS)
    assert got["gdr.decode.sync"] == {"n": 1, "total_s": pytest.approx(
        100 * NS), "self_s": pytest.approx(100 * NS)}
    assert set(got) == {e[0] for e in EVENTS if e[0].startswith("gdr.")}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "gdrbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_reduce_and_serving_readers_on_the_same_events():
    tr = trace.reduce([e[:4] for e in EVENTS])
    assert tr.window_s == pytest.approx(1000 * NS)
    assert tr.busy_s == pytest.approx(335 * NS)
    assert tr.kernels == 5
    assert [o[0] for o in tr.ops] == [e[0] for e in sorted(
        (e for e in EVENTS if e[1]), key=lambda e: e[2])]
    assert tr.idle_by_host == _approx({
        "host code outside profiled operations": 160 * NS,
        "gdr.encode": 80 * NS, "gdr.beam.select": 85 * NS,
        "gdr.decode.sync": 110 * NS, "gdr.rerank": 230 * NS})
    layer = {"kind": "serve", "units": 10, "window_s": 2.0,
             "flops_per_unit": 1e12, "peak_flops": 1e14, "trace": tr,
             "trace_units": 2, "decoder_bound_s_per_unit": 17 * NS}
    assert _reader("idle_share.serve")(layer) == pytest.approx(66.5)
    assert _reader("kernels_per_retrieve.serve")(layer) == 2.5
    assert _reader("decoder_roofline.serve")(layer) == pytest.approx(20.0)
    assert _reader("mfu.serve")(layer) == pytest.approx(5.0)


def test_nesting_and_the_window():
    nest = spans._Nest([("a", 0, 100), ("b", 10, 20), ("c", 30, 90),
                        ("d", 40, 50), ("e", 200, 300)])
    assert nest.parent == [None, 0, 0, 2, None]
    assert [nest.name_at(t) for t in (5, 15, 25, 45, 60, 95, 150, 250)] \
        == ["a", "b", "a", "d", "c", "a", spans.OUTSIDE, "e"]
    with pytest.raises(RuntimeError):
        spans.attribute([e for e in EVENTS if e[0] != trace.WINDOW])


def test_a_cpu_trace_of_the_port_spans():
    """On the CPU the host side reads: the spans' times, no device op."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gdr_tpu_torch.utils.timing import span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(3):
                with span("gdr.retrieve", "rows=2"):
                    with span("gdr.decode.sync"):
                        torch.ones(4).sum()
    got = spans.attribute(spans.events(prof))
    assert got.device_by_span == {}
    assert got.host_by_span["gdr.retrieve"]["n"] == 3
    assert got.host_by_span["gdr.decode.sync"]["n"] == 3
    assert 0 < got.host_by_span["gdr.decode.sync"]["total_s"] \
        < got.host_by_span["gdr.retrieve"]["total_s"]
    assert set(got.idle_by_span) <= {spans.OUTSIDE, "gdr.retrieve",
                                     "gdr.decode.sync"}
