"""Serving: a closed loop of one caller that sends a batch of queries to
``Evaluator.retrieve`` (the port's packed float32 path, as ``cli
retrieve --packed`` and ``eval`` serve it) and waits until the batch's
top-R doc ids and fused scores are on the host before it sends the next.

Set-up: the world (``traffic/world.py``), the trie (the port's
``build_trie``), the store and the weights drawn on the device from the
seed, the evaluator, two warm retrieves of the cell's batch (they build
the U table and every GEMM plan, and load the kernels from
``build/kernels``), and one retrieve whose kernel launches are counted
(the main path: every decoder kernel ``layers × steps`` times, one packed
scorer).  The window then runs for ``seconds``; with ``trace`` a further
``trace_requests`` retrieves run under the profiler.  After the window
the program is freed and a sample of the finished retrieves, drawn from
the seed and holding the longest query, is compared with
``reference/serve.py``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from gdrbench import compare, costs, trace
from gdrbench.reference import model as ref_model
from gdrbench.reference import serve as ref_serve
from gdrbench.traffic.world import (bench_cid_map, queries, sub_seed,
                                    unit_store)
from gdrbench.weights import load_into, make_weights

SEED_WEIGHTS, SEED_STORE, SEED_QUERIES, SEED_SAMPLE = 1, 2, 3, 4


def _world(ctx):
    cfg = ctx.config
    st = cfg["store"]
    cid_map = bench_cid_map(st["n_docs"], st["kary"], st["leaf_cap"])
    depth = max(len(c.split("-")) for c in cid_map)
    max_len = min(cfg["eval"]["max_output_length"], depth + 1)
    return cid_map, max_len


def _host(res, rr) -> dict:
    """The reply on the host: top-R doc ids and fused scores first (the
    first copy waits for the retrieve), then the beams."""
    return {"doc_ids": rr.doc_ids.cpu().numpy(),
            "fused": rr.scores.cpu().numpy(),
            "sequences": res.sequences.cpu().numpy(),
            "beam_scores": res.scores.cpu().numpy(),
            "valid": res.valid.cpu().numpy()}


def run(ctx) -> dict:
    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import EvalConfig, ModelConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models.gdr import GenerativeRetriever
    from gdr_tpu_torch.ops.trie import build_trie

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    m, st, ecfg = cfg["model"], cfg["store"], cfg["eval"]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cid_map, max_len = _world(ctx)
    trie = build_trie(cid_map, st["kary"],
                      max_docs_per_cluster=st["max_docs_per_cluster"])
    store = unit_store(st["n_docs"], m["encoder_d_model"],
                       sub_seed(ctx.seed, SEED_STORE), dev)
    weights = make_weights(m, sub_seed(ctx.seed, SEED_WEIGHTS), dev)
    with torch.device("meta"):
        model = GenerativeRetriever(ModelConfig(**m))
    load_into(model, weights, torch.float32)
    del weights
    ev = Evaluator(model.eval(), trie, store, EvalConfig(**ecfg),
                   packed=st.get("layout") == "packed")
    del store
    b, s = tr["batch"], cfg["max_input_length"]
    # request i sends batch i % pool: past the pool the inputs repeat
    pool = math.ceil(ctx.seconds * tr["max_requests_per_s"]) \
        + tr["trace_requests"]
    ids, mask = queries(tr["lengths"], pool * b, s, m["vocab_size"],
                        sub_seed(ctx.seed, SEED_QUERIES))
    ids, mask = ids.reshape(pool, b, s), mask.reshape(pool, b, s)

    for i in range(2):                                   # warm-up
        _host(*ev.retrieve(ids[i], mask[i]))
    if cuda:
        kernels.reset_launch_counts()
        ev.retrieve(ids[0], mask[0])
        sync()
        got = {k: v for k, v in kernels.launch_counts().items() if v}
        layers_steps = m["num_decoder_layers"] * max_len
        want = {**dict.fromkeys(costs.DECODER, layers_steps),
                "packed_scores": 1}
        if got != want:
            raise RuntimeError(f"launches of one retrieve {got}, want {want} "
                               f"(the main path)")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()

    lat, outs = [], []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    i = 0
    while True:
        start = time.perf_counter()
        if start - t0 >= ctx.seconds:
            break
        outs.append(_host(*ev.retrieve(ids[i % pool], mask[i % pool])))
        lat.append(time.perf_counter() - start)
        i += 1
    window_s = time.perf_counter() - t0
    n = i

    layer = {"kind": "serve", "units": n, "window_s": window_s,
             "flops_per_unit": costs.retrieve_flops(
                 m, b, ecfg["num_beams"], max_len, s,
                 st["n_docs"] / len(cid_map)),
             "peak_flops": costs.H100_F32_FLOPS,
             "decoder_bound_s_per_unit": costs.decoder_bound_s(
                 m, b, ecfg["num_beams"], max_len, s, 4,
                 costs.H100_F32_FLOPS)}
    if ctx.trace:
        k = tr["trace_requests"]

        def traced_requests():
            for j in range(n, n + k):
                _host(*ev.retrieve(ids[j % pool], mask[j % pool]))
        layer["trace"] = trace.traced(traced_requests)
        layer["trace_units"] = k
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    del ev, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reps = np.arange(n) % pool
    checks, info = check(ctx, ids[reps], mask[reps], outs, max_len)
    return {"attempted": n * b, "failed": 0,
            "end_to_end": {"setup_s": setup_s,
                           "retrieve_p95_ms": float(np.percentile(lat, 95))
                           * 1e3,
                           "queries_per_s": n * b / window_s},
            "layer": layer, "memory_peak_bytes": peak, "checks": checks,
            "info": {**info, "retrieves": n,
                     "retrieve_p50_ms": float(np.percentile(lat, 50)) * 1e3}}


def sample(ctx, n: int, mask: np.ndarray) -> list[int]:
    """The retrieves compared: the first that holds the longest query,
    and others drawn from the seed, ``check_requests`` in all."""
    longest = int(np.argmax(mask[:n].sum(-1).max(-1)))
    rng = np.random.default_rng(sub_seed(ctx.seed, SEED_SAMPLE))
    rest = [int(j) for j in rng.permutation(n) if j != longest]
    return [longest] + rest[:max(ctx.traffic["check_requests"] - 1, 0)]


def reference_outputs(ctx, ids, mask, picks, max_len, tf32: bool = False):
    """The plain reference's beams and re-rank of the requests ``picks``
    (``tf32``: its products in TF32, the control)."""
    cfg, dev = ctx.config, ctx.device
    m, st, ecfg = cfg["model"], cfg["store"], cfg["eval"]
    cid_map, _ = _world(ctx)
    ref_model.f32_matmul_only()
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        w = make_weights(m, sub_seed(ctx.seed, SEED_WEIGHTS), dev)
        store = unit_store(st["n_docs"], m["encoder_d_model"],
                           sub_seed(ctx.seed, SEED_STORE), dev)
        trie = ref_serve.Trie(cid_map, m["kary"])
        out = []
        with torch.no_grad():
            for j in picks:
                out.append(ref_serve.retrieve(
                    w, m, ecfg, store, trie, cid_map,
                    torch.as_tensor(ids[j], device=dev),
                    torch.as_tensor(mask[j], device=dev), max_len))
    finally:
        ref_model.f32_matmul_only()
    return out, {tuple(int(x) for x in c.split("-")) for c in cid_map}


def as_served(beams, rr, kary: int, k: int, max_len: int) -> dict:
    """The reference's answer in the served arrays' form (the control is
    compared as the program is)."""
    b = len(beams.cids)
    seqs = np.zeros((b, k, max_len + 1), np.int64)
    scores = np.full((b, k), -1e9, np.float32)
    valid = np.zeros((b, k), bool)
    for q in range(b):
        for j, c in enumerate(beams.cids[q]):
            toks = [p * kary + 2 + d for p, d in enumerate(c)] + [1]
            seqs[q, j, 1:1 + len(toks)] = toks
            scores[q, j] = beams.scores[q][j]
            valid[q, j] = True
    return {"sequences": seqs, "beam_scores": scores, "valid": valid,
            "doc_ids": rr.doc_ids, "fused": rr.fused}


def check(ctx, ids, mask, outs, max_len) -> tuple[dict, dict]:
    """Each compared number beside its limit, and what the comparison
    left out."""
    tr, m = ctx.traffic, ctx.config["model"]
    picks = sample(ctx, len(outs), mask)
    t = time.perf_counter()
    refs, cids = reference_outputs(ctx, ids, mask, picks, max_len)
    parts = [compare.serve_numbers(outs[j], beams, rr, m["kary"],
                                   ctx.config["eval"]["score_rates"], cids)
             for j, (beams, rr) in zip(picks, refs)]
    got = compare.merge(parts)
    checks = {k: (got[k], tr["limits"][k]) for k in compare.SERVE_NUMBERS}
    info = {"compared_queries": got["queries"],
            "tie_excluded": got["tie_excluded"],
            "reference_s": time.perf_counter() - t}
    return checks, info
