"""The f32 decoder path on one CUDA device: the GEMM's launch plans and the
fit of their cost model, and the f32 sublayers, GEMMs and retrieve of any
checkout of this repository.

    python3 gdr_tpu_torch/kernels/f32_bench.py sweep [--out FILE.json]
                                             [--rows 1,8,31,32,64,100,128]
                                             [--near 1.5]
    python3 gdr_tpu_torch/kernels/f32_bench.py compare [--root DIR]
                                             [--out FILE.json]

``sweep``: for each of the four (N, K) products of a t5-base decoder layer
at each row count, above 128 rows the plans of the warp-specialised ring
that its chooser weighs (``gdr_gemm_ws_plans``: both tiles, their k-tiles
cut into 1, 2 or 4 units or one a k-tile, on one or two blocks an SM, the
tile's ring; the best of those again at every other depth), up to 128
rows every plan of the small-row kernel (strips of 48 or 64 columns,
clusters of 1-8 blocks, rings of 2, 4 or 8 stages), each running the
epilogue the main path gives the product, held to the plain version (atol
1e-4 + rtol 1e-5).  Prints, per shape, the cost model's plan and its
time, the fastest plans, f32 ``torch.matmul`` (TF32 off) and the bound (W
and A read once, C written once, at 3.35 TB/s; the FMAs at 67 TFLOP/s);
then the constants of ``plan_time_ws`` and of ``plan_time_rows``
(``csrc/decode_sublayers.cu``) fitted, by scipy's Nelder-Mead on the log
of the times, to the plans within ``--near`` of their shape's best, the
library itself evaluating each model (``gdr_gemm_ws_time``,
``gdr_gemm_rows_time``), and how the fitted models' picks compare with
the best.

``compare`` imports ``gdr_tpu_torch`` and ``chip_smoke`` from ``--root``
(default: this checkout), so that one script times two commits alike.  It
uses only entry points that every slice since the f32 path had: the three
f32 sublayers at the main path's row counts (32, 992 and 3,200 rows at
positions 0, 1 and 3 of a 4-position cache, 40 encoder positions) and per
retrieve (6·t32 + 6·t992 + 12·t3200), and at query generation's shape
(320 rows, one beam each over 64 encoder positions, position 39 of 40);
the f32 GEMM alone at its four shapes and 1 / 31 / 32 / 100 / 320 / 992 /
3,200 rows;
and one f32 retrieve as ``cli retrieve --packed`` serves it (t5-base in
f32, seeded weights, the 334,314-doc unit store packed in f32, 32 queries
× 40 tokens, beam 100, top-R 100): launches, then 3 timed calls after a
warm one, and the peak.

Device time of a kernel call: 20 calls captured in one CUDA graph, the
graph replayed between CUDA events (one call a graph, as ``chip_smoke.py``
phase 2 times it, is paced by the host's graph launches below ~10 us).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

D, H, DKV, DFF = 768, 12, 64, 3072
SHAPES = ((3 * D, D, "round"), (D, D, "residual"), (DFF, D, "relu"),
          (D, DFF, "residual"))
FMA_PEAK = 67e12 / 2 / 132          # an SM's share of the FMA rate, FMA/s
# the warp-specialised ring's cuts the sweep times (besides one a k-tile)
SWEEP_CUTS = (1, 2, 4)
# the small-row kernel (M <= 128): strips, clusters and rings the sweep
# runs (the chooser takes 4 stages)
ROWS_BN, ROWS_CLUSTERS, ROWS_STAGES = (48, 64), (1, 2, 3, 4, 6, 8), (2, 4, 8)
ROWS_MAX_M = 128
# main path: width -> (position, weight per retrieve); 4-position cache
WIDTHS = {1: (0, 6), 31: (1, 6), 100: (3, 12)}


CALLS = 20          # calls of one timed graph


def time_ms(fn, n: int = 10, calls: int = CALLS) -> float:
    """Device ms of one call: ``fn(0)`` ... ``fn(calls - 1)`` captured in one
    CUDA graph, back to back as the replayed decode runs its kernels, the
    graph replayed ``n`` times between CUDA events.  A GEMM's call i reads
    weight copy i, so that W comes from HBM as the decode's layers do."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * calls)


def _rand(dev, seed: int):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std
    return rn


# ------------------------------------------------------------------ sweep

def rows_plans(m: int, n: int, k: int, sms: int):
    """(bn, cluster, stages) of every small-row plan the sweep runs at M, N,
    K: those the kernel takes."""
    return [(bn, cl, st) for bn in ROWS_BN for cl in ROWS_CLUSTERS
            for st in ROWS_STAGES
            if rows_ms(bn, cl, st, m, n, k, sms) is not None]


def bound_ms(m: int, n: int, k: int) -> float:
    """The least time of the product: W and A read once, C written once
    (and the residual read) at 3.35 TB/s, or its FMAs at 67 TFLOP/s."""
    return 1e3 * max(4.0 * (m * k + n * k + 2 * m * n) / 3.35e12,
                     2.0 * m * n * k / 67e12)


def sweep(rows, dev) -> list[dict]:
    import torch

    from gdr_tpu_torch.kernels import decode as kd

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rn = _rand(dev, 0)
    out = []
    for m in rows:
        for n, k, epi in SHAPES:
            a, w = rn(m, k), rn(n, k, std=k ** -0.5)
            ws = [w] + [w.clone() for _ in range(CALLS - 1)]
            kw = (dict(resid=rn(m, n)) if epi == "residual"
                  else dict(scale=1 + rn(k, std=0.1)))
            want = kd.gemm_plain(a, w, epi, **kw)

            def timed(plan):
                got = kd.gemm(a, w, epi, plan=plan, **kw)
                torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
                return time_ms(lambda i: kd.gemm(a, ws[i], epi, plan=plan,
                                                 **kw))
            wplans = []
            if m > ROWS_MAX_M:
                kt = -(-k // 32)

                def ws_timed(bm, bn, st, s, g):
                    plan = kd.ws_plan(m, n, k, bm, bn, s, g, st)
                    return (timed(plan), bm, bn, st, s, g)
                wplans = [ws_timed(*p) for p in ws_plans(m, n, k, sms)
                          if p[3] in SWEEP_CUTS or p[3] == kt]
                wplans.sort()
                _, bm, bn, st0, s, g = wplans[0]
                # the best plan's ring at every other depth that fits the
                # 227 KB of a block (the kernel refuses the others)
                for st in range(2, 9):
                    if st != st0:
                        try:
                            wplans.append(ws_timed(bm, bn, st, s, g))
                        except RuntimeError:
                            pass
                wplans.sort()
            rplans = []
            if m <= ROWS_MAX_M:
                for bn, cl, st in rows_plans(m, n, k, sms):
                    rplans.append((timed(kd.rows_plan(m, n, bn, cl, st)),
                                   bn, cl, st))
                rplans.sort()
            model = kd.gemm_plan(m, n, k, dev, torch.float32)
            row = dict(m=m, n=n, k=k, epi=epi, ws_plans=wplans,
                       rows_plans=rplans,
                       model_plan=[model.rows, model.bn, model.splits,
                                   model.stages, model.blocks, model.kernel],
                       model_ms=time_ms(lambda i: kd.gemm(a, ws[i], epi,
                                                          **kw)),
                       matmul_ms=time_ms(lambda i: a @ ws[i].t()),
                       bound_ms=bound_ms(m, n, k))
            out.append(row)
            kind = "rows" if model.kernel == kd.KERNEL_ROWS else "ring_ws"
            print(f"M={m:5d} N={n:5d} K={k:5d}: model {kind} "
                  f"{model.rows}x{model.bn} s{model.splits} g{model.blocks} "
                  f"st{model.stages} {row['model_ms']:.4f} ms"
                  + ("; ring_ws best " + ", ".join(
                      f"{bm}x{bn} st{st} s{s} g{g} {t:.4f}"
                      for t, bm, bn, st, s, g in wplans[:3]) if wplans else "")
                  + ("; rows best " + ", ".join(
                      f"bn{bn} c{cl} st{st} {t:.4f}"
                      for t, bn, cl, st in rplans[:3]) if rplans else "")
                  + f"; torch.matmul {row['matmul_ms']:.4f} ms; bound "
                  f"{row['bound_ms']:.4f} ms", flush=True)
    return out


def ws_plans(m: int, n: int, k: int, sms: int) -> list[tuple]:
    """(rows, columns, stages, cuts, blocks) of every plan of the
    warp-specialised ring that its chooser weighs at M, N, K, in its order
    (``gdr_gemm_ws_plans``)."""
    import ctypes

    from gdr_tpu_torch.kernels import build
    from gdr_tpu_torch.kernels import decode as kd

    lib, count = kd._lib(), ctypes.c_int()
    build.check(lib, lib.gdr_gemm_ws_plans(m, n, k, sms, None, 0,
                                           ctypes.byref(count)), "ws_plans")
    buf = (ctypes.c_int * (5 * count.value))()
    build.check(lib, lib.gdr_gemm_ws_plans(m, n, k, sms, buf, count.value,
                                           ctypes.byref(count)), "ws_plans")
    return [tuple(buf[5 * i:5 * i + 5]) for i in range(count.value)]


WS_FIT = ("fma_per_sm", "lone", "part_per_sm", "latency")    # WsModel's fields
WS_START = (0.65, 0.85, 60e9, 1e-5)


def ws_ms(bm: int, bn: int, s: int, g: int, m: int, n: int, k: int,
          sms: int, model=None) -> float | None:
    """The warp-specialised ring's modelled ms of a plan
    (``gdr_gemm_ws_time``, the chooser's own model) with ``model`` =
    WsModel's four constants (the FMA rate as a share of the SM's; None:
    the fitted ones); None for a tile or cut the ring does not have."""
    import ctypes

    from gdr_tpu_torch.kernels import decode as kd

    arr = None
    if model is not None:
        arr = (ctypes.c_double * 4)(model[0] * FMA_PEAK, *model[1:])
    out = ctypes.c_double()
    err = kd._lib().gdr_gemm_ws_time(m, n, k, bm, bn, s, g, sms, arr,
                                     ctypes.byref(out))
    return None if err else 1e3 * out.value


ROWS_FIT = ("fma_per_sm", "latency", "w_per_block", "a_per_block",
            "part_per_sm")                      # RowsModel's fields
ROWS_START = (0.45, 4e-6, 20e9, 60e9, 100e9)


def rows_ms(bn: int, cl: int, st: int, m: int, n: int, k: int, sms: int,
            model=None) -> float | None:
    """The small-row kernel's modelled ms of a plan (``gdr_gemm_rows_time``,
    the chooser's own model) with ``model`` = RowsModel's five constants
    (the FMA rate as a share of the SM's; None: the fitted ones); None
    where the kernel does not run the plan."""
    import ctypes

    from gdr_tpu_torch.kernels import decode as kd

    arr = None
    if model is not None:
        arr = (ctypes.c_double * 5)(model[0] * FMA_PEAK, *model[1:])
    out = ctypes.c_double()
    err = kd._lib().gdr_gemm_rows_time(m, n, k, bn, cl, st, sms, arr,
                                       ctypes.byref(out))
    return None if err else 1e3 * out.value


def fit_rows(rows: list[dict], near: float, sms: int) -> None:
    """The small-row model's constants fitted to its plans."""
    from scipy.optimize import minimize

    data = [(bn, cl, st, r["m"], r["n"], r["k"], t)
            for r in rows if r["rows_plans"]
            for t, bn, cl, st in r["rows_plans"]
            if t <= near * r["rows_plans"][0][0]]
    if not data:
        return

    def loss(p):
        c = [math.exp(x) for x in p]
        return sum((math.log(rows_ms(*d[:6], sms, c)) - math.log(d[6])) ** 2
                   for d in data)
    p = [math.log(x) for x in ROWS_START]
    for _ in range(3):
        p = minimize(loss, p, method="Nelder-Mead",
                     options=dict(maxiter=40000, maxfev=40000)).x
    c = [math.exp(x) for x in p]
    print("fitted: " + ", ".join(
        f"{name} = {v:.3g}" for name, v in zip(ROWS_FIT, c))
        + f" (fma_per_sm as a share of 67e12 / 2 / 132; loss {loss(p):.3f} "
        f"over {len(data)} plans)")
    picks = best = 0.0
    for r in rows:
        if not r["rows_plans"]:
            continue
        shape = (r["m"], r["n"], r["k"], sms, c)
        t, bn, cl, st = min(r["rows_plans"],
                            key=lambda x: rows_ms(*x[1:], *shape))
        picks += t
        best += r["rows_plans"][0][0]
        print(f"  M={r['m']:5d} N={r['n']:5d} K={r['k']:5d}: fitted pick "
              f"bn{bn} c{cl} st{st} {t:.4f} ms (model "
              f"{rows_ms(bn, cl, st, *shape):.4f}), best "
              f"{r['rows_plans'][0][0]:.4f}")
    print(f"  sum of the fitted picks {picks:.4f} ms, of the best {best:.4f}")


def fit_ws(rows: list[dict], near: float, sms: int) -> None:
    """The warp-specialised ring's constants fitted to its plans above 128
    rows (at the depth the chooser gives each tile); then, per shape, the
    fitted pick beside the best."""
    from scipy.optimize import minimize

    depth = {p[:2]: p[2] for r in rows if r["ws_plans"]
             for p in ws_plans(r["m"], r["n"], r["k"], sms)}
    rows = [dict(r, ws_plans=[x for x in r["ws_plans"]
                              if x[3] == depth[x[1:3]]])
            for r in rows if r["ws_plans"]]
    data = [(bm, bn, s, g, r["m"], r["n"], r["k"], t) for r in rows
            for t, bm, bn, st, s, g in r["ws_plans"]
            if t <= near * r["ws_plans"][0][0]]
    if not data:
        return

    def loss(p):
        c = [math.exp(x) for x in p]
        return sum((math.log(ws_ms(*d[:7], sms, c)) - math.log(d[7])) ** 2
                   for d in data)
    p = [math.log(x) for x in WS_START]
    for _ in range(3):
        p = minimize(loss, p, method="Nelder-Mead",
                     options=dict(maxiter=40000, maxfev=40000)).x
    c = [math.exp(x) for x in p]
    print("fitted: " + ", ".join(
        f"{name} = {v:.3g}" for name, v in zip(WS_FIT, c))
        + f" (fma_per_sm as a share of 67e12 / 2 / 132; loss {loss(p):.3f} "
        f"over {len(data)} plans)")
    picks = best = 0.0
    for r in rows:
        shape = (r["m"], r["n"], r["k"], sms, c)
        t, bm, bn, st, s, g = min(r["ws_plans"], key=lambda x: ws_ms(
            x[1], x[2], x[4], x[5], *shape))
        picks += t
        best += r["ws_plans"][0][0]
        print(f"  M={r['m']:5d} N={r['n']:5d} K={r['k']:5d}: fitted pick "
              f"{bm}x{bn} st{st} s{s} g{g} {t:.4f} ms (model "
              f"{ws_ms(bm, bn, s, g, *shape):.4f}), best "
              f"{r['ws_plans'][0][0]:.4f}, bound {r['bound_ms']:.4f}")
    print(f"  sum of the fitted picks {picks:.4f} ms, of the best {best:.4f}")


# ---------------------------------------------------------------- compare

def sublayers(dev, r: int, beams: int, pos: int, lmax: int, enc: int,
              seed: int) -> dict:
    """Device ms of the three f32 sublayers at r rows (``beams`` a query)."""
    from gdr_tpu_torch.kernels import decode as kd

    rn = _rand(dev, seed)
    b = r // beams
    x, scale = rn(r, D), 1 + rn(D, std=0.1)
    wqkv, wo = rn(3 * D, D, std=0.02), rn(D, D, std=0.02)
    bias_row, ck, cv = rn(lmax, H, std=0.5), rn(lmax, r, D), rn(lmax, r, D)
    wcq, wco = rn(D, D, std=0.02), rn(D, D, std=0.02)
    xk, xv, xb = rn(b, H, enc, DKV), rn(b, H, enc, DKV), rn(b, H, enc, std=0.5)
    wi, wo2 = rn(DFF, D, std=0.02), rn(D, DFF, std=0.02)
    return {
        "self_attn_sublayer": time_ms(lambda i: kd.self_attn_sublayer(
            x, pos, scale, wqkv, wo, bias_row, ck, cv, heads=H, d_kv=DKV)),
        "cross_attn_sublayer": time_ms(lambda i: kd.cross_attn_sublayer(
            x, scale, wcq, wco, xk, xv, xb, beams, heads=H, d_kv=DKV)),
        "ffn_sublayer": time_ms(lambda i: kd.ffn_sublayer(x, scale, wi,
                                                           wo2)),
    }


def retrieve(dev, smoke, timed: int = 3) -> dict:
    """An f32 retrieve on the packed f32 layout at phase 4's operating
    point, with its launches, wall ms and peak."""
    import numpy as np
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import EvalConfig, ModelConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    cfg = ModelConfig().scaled("base")
    trie = smoke.build_nq_scale_trie(smoke.N_DOCS, cfg.kary, 30, 64)
    g = torch.Generator(device=dev).manual_seed(7)
    store = torch.randn(smoke.N_DOCS, cfg.encoder_d_model, generator=g,
                        device=dev)
    store = store / store.norm(dim=1, keepdim=True)
    with torch.device(dev):
        model = GenerativeRetriever(cfg)
    model = init_weights(model, torch.Generator(device=dev).manual_seed(0)
                         ).eval()
    ev = Evaluator(model, trie, store, EvalConfig(
        num_beams=100, num_return_sequences=100,
        max_output_length=cfg.max_output_length, length_penalty=0.8),
        packed=True)
    del store
    rng = np.random.default_rng(0)
    ids = rng.integers(2, cfg.vocab_size, size=(32, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    torch.cuda.reset_peak_memory_stats()
    ev.retrieve(ids, mask)                               # warm
    kernels.reset_launch_counts()
    res, rr = ev.retrieve(ids, mask)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    valid = int(res.valid.sum())
    each = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev.retrieve(ids, mask)
        torch.cuda.synchronize()
        each.append((time.perf_counter() - t) * 1e3)
    return dict(retrieve_ms=sum(each) / len(each), retrieve_ms_each=each,
                launches=launches, valid_beams=valid,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def compare(root: Path, dev) -> dict:
    from gdr_tpu_torch.kernels import decode as kd

    import chip_smoke as smoke
    out: dict = {"root": str(root), "sublayers": {}, "per_retrieve": {},
                 "gemm": {}}
    for w, (pos, _) in WIDTHS.items():
        out["sublayers"][f"R={32 * w}"] = sublayers(dev, 32 * w, w, pos, 4,
                                                     40, seed=w)
    for name in out["sublayers"]["R=32"]:
        out["per_retrieve"][name] = sum(
            wt * out["sublayers"][f"R={32 * w}"][name]
            for w, (_, wt) in WIDTHS.items())
    out["sublayers"]["qg R=320"] = sublayers(dev, 320, 1, 39, 40, 64, seed=5)
    rn = _rand(dev, 9)
    for m in (1, 31, 32, 100, 320, 992, 3200):
        for n, k, epi in SHAPES:
            a, wt = rn(m, k), rn(n, k, std=k ** -0.5)
            wts = [wt] + [wt.clone() for _ in range(CALLS - 1)]
            kw = (dict(resid=rn(m, n)) if epi == "residual"
                  else dict(scale=1 + rn(k, std=0.1)))
            out["gemm"][f"M={m} N={n} K={k}"] = time_ms(
                lambda i: kd.gemm(a, wts[i], epi, **kw))
    out["retrieve"] = retrieve(dev, smoke)
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("sweep", "compare"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--rows", default="1,8,31,32,64,100,128")
    ap.add_argument("--near", type=float, default=1.5)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    here = Path(__file__).resolve().parent        # run as a script: not a package dir
    sys.path[:] = [str(root)] + [p for p in sys.path if Path(p or ".").resolve() != here]
    import torch
    if not torch.cuda.is_available():
        print("f32_bench: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.mode == "sweep":
        out = sweep([int(x) for x in args.rows.split(",")], dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        fit_ws(out, args.near, sms)
        fit_rows(out, args.near, sms)
    else:
        out = compare(root, dev)
        print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
