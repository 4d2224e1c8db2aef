#!/usr/bin/env python3
"""One traced run of a serving cell of the benchmark, read through the
program's spans (``gdrbench/spans.py``): device time, host time and idle
gaps by ``gdr.`` span, the host syncs, CUDA graph pieces replayed and
captured and eager decodes (the counter registry) and the launches by
kernel name in the trace per retrieve of the f32 GEMM, the routed experts,
the MLA decode and the KDA kernels (and their device time; the top-k
experts' mean rows a work chunk and the share of assignments that fell
to held experts beside them, and the KDA state rows a retrieve), the share of the device time
inside ``gdr.retrieve`` that encode, decoder forward, beam selection and
re-rank cover, or where the decode replays CUDA graphs the device and
host time of ``gdr.decode.replay`` (the stage spans inside the graphs are
not recorded then, and their stage metrics are null), and what the spans
cost: ``span()`` with no
profiler (ns a call), and the traced stretch with the spans against the
same stretch with ``span`` replaced by its no-op, alternated
``--repeats`` times.  The cell runs as ``gdrbench/run.py --trace 1`` runs
it (its result line, ``correct`` included, is kept) with the traced
stretch taken over here.  Prints one JSON object and writes it to
``chiprun_out/serve_spans_<cell>.json``.

    python3 tools/serve_spans.py --workload serve-b1 --seed 7 --seconds 5
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gdrbench import harness, spans, trace  # noqa: E402

# the spans that open inside gdr.retrieve, and the four that hold its
# device work: encode, decoder forward, beam selection, re-rank
RETRIEVE = ("gdr.retrieve", "gdr.encode", "gdr.decode.init",
            "gdr.decode.step", "gdr.decode.forward", "gdr.beam.select",
            "gdr.decode.sync", "gdr.decode.replay", "gdr.decode.finalize",
            "gdr.query", "gdr.rerank")
REPLAY = "gdr.decode.replay"
# the f32 GEMM's kernels: the small-row kernel and the warp-specialised ring
GEMM_F32 = ("gdr::gemm_f32_ring_rows", "gdr::gemm_f32_ring_ws")
# the routed experts' kernels (Switch's top-1, DeepSeek-V3's top-k) and
# the MLA decode kernel
EXPERTS = ("gdr::moe_router", "gdr::moe_group", "gdr::moe_up",
           "gdr::moe_down", "gdr::moe_topk_group", "gdr::moe_swiglu_up",
           "gdr::moe_topk_down", "gdr::moe_combine")
MLA = ("gdr::mla_decode",)
KDA = ("gdr::kda_prefill", "gdr::kda_decode")
STAGES = {"encode_device_ms": "gdr.encode",
          "decoder_device_ms": "gdr.decode.forward",
          "beam_device_ms": "gdr.beam.select",
          "rerank_device_ms": "gdr.rerank"}


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span_off_ns(n: int = 1_000_000) -> dict:
    """ns a ``span()`` call and a ``with span(...)`` block take with no
    profiler, beside an empty loop's iteration."""
    from gdr_tpu_torch.utils.timing import span
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    empty = time.perf_counter_ns() - t
    t = time.perf_counter_ns()
    for _ in range(n):
        span("gdr.decode.step")
    call = time.perf_counter_ns() - t
    t = time.perf_counter_ns()
    for _ in range(n):
        with span("gdr.decode.step"):
            pass
    block = time.perf_counter_ns() - t
    return {"empty_loop_ns": empty / n, "span_call_ns": (call - empty) / n,
            "with_span_ns": (block - empty) / n}


class _NoSpans:
    """``span`` replaced by its no-op in every module that imported it."""

    def __enter__(self):
        from gdr_tpu_torch.utils import timing
        self.real = timing.span
        self.mods = [m for m in list(sys.modules.values())
                     if vars(m).get("span") is self.real]
        for m in self.mods:
            m.span = lambda name, args=None: timing._OFF
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.span = self.real


def _traced(record: dict, repeats: int, device):
    """A stand-in for ``trace.traced`` that also keeps the spans, the
    counters of the traced stretch and the stretch's cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.utils import timing
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def profiled(fn):
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                sync()
                t = time.perf_counter()
                fn()
                sync()
                dt = time.perf_counter() - t
        return prof, dt

    def traced(fn):
        kernels.reset_launch_counts()
        prof, dt = profiled(fn)
        record["counts"] = timing.counts()
        evs = spans.events(prof)
        record["spans"] = spans.attribute(evs)
        record["stretch_s"] = dt
        tr = trace.reduce([e[:4] for e in evs])
        record["trace"] = tr
        cost = {"spans_s": [], "no_spans_s": []}
        for _ in range(repeats):
            with _NoSpans():
                cost["no_spans_s"].append(profiled(fn)[1])
            cost["spans_s"].append(profiled(fn)[1])
        record["cost"] = cost
        return tr
    return traced


def rows_a_chunk(result: dict):
    """The top-k experts' mean rows a work chunk over the traced stretch,
    ``moe_held / moe_chunks`` of the result's ``info.routing_traced`` (only
    the held experts' assignments are chunked; ``moe_assignments`` where the
    checkout counts no ``moe_held``, which holds every expert; of at most
    16; None where the cell runs no top-k layer)."""
    routing = result.get("info", {}).get("routing_traced", {})
    chunks = routing.get("moe_chunks")
    rows = routing.get("moe_held", routing.get("moe_assignments"))
    return rows / chunks if chunks else None


def held_share(result: dict):
    """The share of the traced stretch's top-k assignments that fell to
    the experts this card holds (None where the cell routes none, or the
    checkout counts no ``moe_held``)."""
    routing = result.get("info", {}).get("routing_traced", {})
    if not routing.get("moe_assignments") or "moe_held" not in routing:
        return None
    return routing["moe_held"] / routing["moe_assignments"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose BENCHMARK.json names the cell")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    harness.set_cache_dirs(ROOT)
    import torch
    device = torch.device(args.device)
    run = _module(ROOT / "gdrbench" / "run.py")
    record: dict = {}
    trace.traced = _traced(record, args.repeats, device)
    result = run.execute(args.workload, args.seed, args.seconds, True,
                         args.device, root=args.root, t_start=T_START)
    sp, tr = record["spans"], record["trace"]
    k = harness.cell(harness.load_spec(args.root), args.workload,
                     args.root).traffic["trace_requests"]
    roof = _module(ROOT / "gdrbench" / "metrics" / "decoder_roofline.serve.py")
    host = sp.host_by_span
    inside = sum(v for n, v in sp.device_by_span.items() if n in RETRIEVE)
    # a stage span that no range recorded ran inside a replayed graph: its
    # stage time is unknown, not 0
    staged = sum(sp.device_by_span.get(n, 0.0) for n in STAGES.values()
                 if n in host)
    per = {m: 1e3 * sp.device_by_span.get(n, 0.0) / k if n in host else None
           for m, n in STAGES.items()}
    counts = record["counts"]
    retrieve_s = host.get("gdr.retrieve", {}).get("total_s", 0.0)
    sync_s = host.get("gdr.decode.sync", {}).get("total_s", 0.0)
    per.update(dispatch_ms=1e3 * (retrieve_s - sync_s) / k,
               sync_wait_ms=1e3 * sync_s / k,
               host_syncs_per_retrieve=counts["host_syncs"] / k,
               replay_device_ms=1e3 * sp.device_by_span.get(REPLAY, 0.0) / k,
               replay_host_ms=1e3 * host.get(REPLAY, {}).get("total_s", 0.0)
               / k,
               **{f"{n}_per_retrieve": counts[n] / k
                  for n in ("graph_replays", "graph_captures",
                            "eager_decodes")},
               **{f"{n[5:]}_per_retrieve": sum(
                   trace.short_name(o) == n for o, _, _ in tr.ops) / k
                  for n in GEMM_F32 + EXPERTS + MLA + KDA})
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": result["device"], "correct": result["correct"],
        "metrics": {m: v["value"] for m, v in result["metrics"].items()},
        "per_retrieve": per,
        "device_in_retrieve_ms": 1e3 * inside / k,
        "stages_share_of_retrieve": staged / inside if inside else None,
        "stages_not_recorded": [n for n in STAGES.values() if n not in host],
        "decoder_kernels_ms": 1e3 * tr.device_time(roof.is_decoder_kernel)
        / k,
        "gemm_f32_ms": 1e3 * tr.device_time(lambda n: "gemm_f32_ring" in n)
        / k,
        "experts_ms": 1e3 * tr.device_time(lambda n: "gdr::moe_" in n) / k,
        "expert_rows_a_chunk": rows_a_chunk(result),
        "mla_ms": 1e3 * tr.device_time(lambda n: "gdr::mla_decode" in n) / k,
        "kda_ms": 1e3 * tr.device_time(lambda n: "gdr::kda_" in n) / k,
        "kda_per_retrieve": sum(trace.short_name(o) in KDA
                                for o, _, _ in tr.ops) / k,
        "kda_state_rows_per_retrieve": counts.get("kda_state_rows", 0) / k,
        "expert_held_share": held_share(result),
        "launches": {n: c / k for n, c in record["counts"].items() if c},
        "window_s": tr.window_s, "busy_s": tr.busy_s,
        "kernels_per_retrieve": tr.kernels / k,
        "device_by_span": sp.device_by_span,
        "idle_by_span": sp.idle_by_span,
        "host_by_span": host,
        "idle_by_host": dict(sorted(tr.idle_by_host.items(),
                                    key=lambda kv: -kv[1])[:10]),
        "stretch_ms_per_retrieve": {
            "spans": [1e3 * s / k for s in record["cost"]["spans_s"]],
            "no_spans": [1e3 * s / k for s in record["cost"]["no_spans_s"]]},
        "span_off": span_off_ns(),
        "checks": result["checks"],
    }
    line = json.dumps(out)
    dest = ROOT / "chiprun_out" / f"serve_spans_{args.workload}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
