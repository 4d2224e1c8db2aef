#!/usr/bin/env python3
"""Times the decoder's bf16 GEMM (``gdr_tpu_torch.kernels.decode.gemm``)
under many launch plans at the main path's shapes, on one CUDA device, to
check and tune the cost model that picks a plan (``gemm_plan``).

    python3 tools/gemm_plan_sweep.py [--out FILE.json] [--rows 32,992,3200]
                                     [--reps 10]

For each of the four (N, K) products of a t5-base decoder layer at each row
count, every instantiated tile with 1 to 16 splits (as long as the units
stay within four waves of the SMs) runs the epilogue the main path gives
the product (round and ReLU after the RMSNorm launch, residual without).
Device time per call: ``--reps`` calls captured back to back in one CUDA
graph, the graph replayed between CUDA events, the time divided by the
calls, so that a kernel shorter than a graph launch is not timed at the
launch rate.  Beside it, for the cost model's plan and ``torch.matmul``,
``chip_smoke._time_ms`` (one call per graph, as phase 2 times it).  Prints,
per shape, the cost model's plan, the fastest plans measured and
``torch.matmul``; the JSON file holds every plan's time.  Each plan's
output is held to the plain version at the bf16 tolerance of
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILES = ((2, 192, 4), (2, 160, 4), (2, 128, 4), (2, 64, 4), (1, 128, 4),
         (1, 96, 6), (1, 64, 6), (1, 32, 8), (1, 16, 8), (1, 8, 8))
SPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 12, 16)


def graph_ms(fn, reps: int, n: int = 10) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the graph replayed ``n`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * reps)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--rows", default="32,992,3200")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gemm_plan_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import GEMM_SHAPES, _close, _time_ms
    from gdr_tpu_torch.kernels import decode as kd

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; {sms} SMs", flush=True)
    g = torch.Generator(device=dev).manual_seed(3)
    warm = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    for _ in range(200):
        warm @ warm
    torch.cuda.synchronize()
    rows_out = []
    for m in (int(r) for r in args.rows.split(",")):
        for n, k, epi in GEMM_SHAPES:
            a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn(n, k, generator=g, device=dev) * k ** -0.5).to(
                torch.bfloat16)
            kw = (dict(resid=torch.randn(m, n, generator=g, device=dev).to(
                torch.bfloat16)) if epi == "residual" else dict(
                scale=(1 + 0.1 * torch.randn(k, generator=g, device=dev)).to(
                    torch.bfloat16)))
            want = kd.gemm_plain(a, w, epi, **kw)
            model = kd.gemm_plan(m, n, k, dev)
            kt = -(-k // 64)
            times = []
            for wg, bn, st in TILES:
                tiles = -(-m // (64 * wg)) * -(-n // bn)
                for s in SPLITS:
                    units = tiles * s
                    if s > kt or (s > 1 and (units > 4 * sms or tiles > 1024)):
                        continue
                    plan = kd.GemmPlan(wg, bn, st, s, units, min(units, sms))
                    call = lambda: kd.gemm(a, w, epi, plan=plan, **kw)
                    _close(f"gemm {plan}", call(), want, "bfloat16")
                    times.append(dict(plan=plan._asdict(),
                                      ms=graph_ms(call, args.reps)))
            model_ms = next(t["ms"] for t in times
                            if t["plan"] == model._asdict())
            best = min(times, key=lambda t: t["ms"])
            mm = graph_ms(lambda: a @ w.t(), args.reps)
            one = dict(model_ms=_time_ms(lambda: kd.gemm(a, w, epi, **kw)),
                       matmul_ms=_time_ms(lambda: a @ w.t()))
            bp = best["plan"]
            print(f"M={m:5d} N={n:5d} K={k:5d} {epi}: model {64 * model.wg}x"
                  f"{model.bn}/{model.splits} ({model.blocks} blocks) "
                  f"{model_ms:.4f} ms; best {64 * bp['wg']}x{bp['bn']}/"
                  f"{bp['splits']} ({bp['blocks']} blocks) {best['ms']:.4f} "
                  f"ms; torch.matmul {mm:.4f} ms; one call per graph: model "
                  f"{one['model_ms']:.4f} ms, torch.matmul "
                  f"{one['matmul_ms']:.4f} ms", flush=True)
            for t in sorted(times, key=lambda t: t["ms"])[:6]:
                p = t["plan"]
                print(f"    {64 * p['wg']}x{p['bn']} st{p['stages']} "
                      f"splits {p['splits']} units {p['units']}: "
                      f"{t['ms']:.4f} ms", flush=True)
            rows_out.append(dict(m=m, n=n, k=k, epi=epi, model=model._asdict(),
                                 model_ms=model_ms, matmul_ms=mm,
                                 one_call_per_graph=one, plans=times))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(device=smi, sms=sms,
                                                  shapes=rows_out)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
