"""Serving on a Switch Transformer generator: ``drivers/serve.py``'s closed
loop of one caller over ``Evaluator.retrieve`` (the packed float32 path),
its world, sample and served arrays, with what the routed experts change:

- the weights (``weights_switch.py``: one draw on the card whose views the
  model takes uncopied, ~23 GB at Switch-Base-128); the model is built on
  the card, whose zeros the draw then replaces: built on the meta device,
  the first ``normal_`` of its initialisers runs PyTorch's Python
  reference, which imports ``torch._dynamo`` with sympy and DTensor, ~10 s
  of the set-up;
- the set-up's launch check: every attention kernel ``layers × steps``
  times, ``ffn_sublayer`` at the dense decoder layers' ``layers × steps``,
  ``expert_sublayer`` once a sparse encoder layer and ``sparse decoder
  layers × steps``, one packed scorer;
- the traced stretch starts from zeroed counters and reads the routing
  counters after it, for the experts' bound (``costs_experts.py``); the
  decoder kernels' bound leaves out the sparse layers' FFN;
- ``info["setup_parts_s"]``: the set-up's seconds by part (process start
  to the driver, world, weights, evaluator, each warm-up retrieve, the
  launch check), each part ending in a sync;
- ``correct``: the plain reference is ``reference/switch.py``.  A query
  whose reference makes a routing decision with its top two router logits
  closer than :data:`ROUTE_TIE_GAP` may send a token to another expert
  under f32 rounding and answer differently; it is left out of the four
  numeric comparisons (checked for ``malformed`` alone), and the share so
  left out is the check ``route_tie_share``.  Which queries are left out
  is decided on the reference's logits alone.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from gdrbench import compare, costs, costs_experts, trace
from gdrbench.drivers.serve import (SEED_QUERIES, SEED_STORE, SEED_WEIGHTS,
                                    _host, _world, sample)
from gdrbench.reference import model as ref_model
from gdrbench.reference import serve as ref_serve
from gdrbench.reference import switch as ref_switch
from gdrbench.traffic.world import queries, sub_seed, unit_store
from gdrbench.weights_switch import load_into, make_weights

# at least 10x the largest |program - reference| router logit that the
# card's test at the cell's widths sees (1.8e-5 over an encoder and three
# decode steps, tests/test_torch_cuda_experts.py, which asserts the 10x;
# 2.4e-5 over four 40-token queries of another seed's weights)
ROUTE_TIE_GAP = 2.5e-4
CHECKS = compare.SERVE_NUMBERS + ("route_tie_share",)


def expected_launches(m: dict, max_len: int) -> dict[str, int]:
    """Kernel launches of one retrieve on the main path."""
    sp = ref_switch.sparse
    enc = sum(sp(i, m["encoder_sparse_step"]) for i in range(m["num_layers"]))
    dec = sum(sp(i, m["decoder_sparse_step"])
              for i in range(m["num_decoder_layers"]))
    layers = m["num_decoder_layers"]
    return {"self_attn_sublayer": layers * max_len,
            "cross_attn_sublayer": layers * max_len,
            "ffn_sublayer": (layers - dec) * max_len,
            "expert_sublayer": enc + dec * max_len, "packed_scores": 1}


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
    parts, mark = {}, [ctx.t_start]

    def part(name: str) -> None:          # the set-up's seconds by part
        sync()
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now
    part("start")                         # imports, the card, the harness
    cid_map, max_len = _world(ctx)
    trie = build_trie(cid_map, st["kary"],
                      max_docs_per_cluster=st["max_docs_per_cluster"])
    store = unit_store(st["n_docs"], m["encoder_d_model"],
                       sub_seed(ctx.seed, SEED_STORE), dev)
    part("world")
    with dev:                             # not meta: see above
        model = GenerativeRetriever(ModelConfig(**m))
    load_into(model, make_weights(m, sub_seed(ctx.seed, SEED_WEIGHTS), dev))
    part("weights")
    ev = Evaluator(model.eval(), trie, store, EvalConfig(**ecfg),
                   packed=st.get("layout") == "packed")
    del store
    b, s = tr["batch"], cfg["max_input_length"]
    pool = math.ceil(ctx.seconds * tr["max_requests_per_s"]) \
        + tr["trace_requests"]
    ids, mask = queries(tr["lengths"], pool * b, s, m["vocab_size"],
                        sub_seed(ctx.seed, SEED_QUERIES))
    ids, mask = ids.reshape(pool, b, s), mask.reshape(pool, b, s)

    part("evaluator")
    for i in range(2):                                   # warm-up
        _host(*ev.retrieve(ids[i], mask[i]))
        part(f"retrieve_{i}")
    info = {}
    if cuda:
        kernels.reset_launch_counts()
        ev.retrieve(ids[0], mask[0])
        sync()
        got = {k: v for k, v in kernels.launch_counts().items() if v}
        want = expected_launches(m, max_len)
        if got != want:
            raise RuntimeError(f"launches of one retrieve {got}, want {want} "
                               f"(the main path)")
        info["routing_one_retrieve"] = {
            k: v for k, v in kernels.launch_counts(experts=True).items()
            if k.startswith("moe_")}
        torch.cuda.reset_peak_memory_stats(dev)
    part("launch_check")
    info["setup_parts_s"] = parts

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
                 st["n_docs"] / len(cid_map))
             + costs_experts.router_flops(m, b, ecfg["num_beams"], max_len,
                                          s),
             "peak_flops": costs.H100_F32_FLOPS,
             "decoder_bound_s_per_unit": costs_experts.decoder_bound_s(
                 m, b, ecfg["num_beams"], max_len, s, 4,
                 costs.H100_F32_FLOPS)}
    if ctx.trace:
        k = tr["trace_requests"]

        def traced_requests():
            for j in range(n, n + k):
                _host(*ev.retrieve(ids[j % pool], mask[j % pool]))
        kernels.reset_launch_counts()
        layer["trace"] = trace.traced(traced_requests)
        layer["trace_units"] = k
        routing = kernels.launch_counts(experts=True)
        layer["expert_bound_s"] = costs_experts.expert_bound_s(m, routing)
        info["routing_traced"] = {name: v for name, v in routing.items()
                                  if name.startswith("moe_")}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    del ev, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reps = np.arange(n) % pool
    checks, checked = check(ctx, ids[reps], mask[reps], outs, max_len)
    return {"attempted": n * b, "failed": 0,
            "end_to_end": {"setup_s": setup_s,
                           "retrieve_p95_ms": float(np.percentile(lat, 95))
                           * 1e3,
                           "queries_per_s": n * b / window_s},
            "layer": layer, "memory_peak_bytes": peak, "checks": checks,
            "info": {**checked, **info, "retrieves": n,
                     "retrieve_p50_ms": float(np.percentile(lat, 50)) * 1e3}}


def reference_outputs(ctx, ids, mask, picks, max_len, tf32: bool = False):
    """The plain reference's beams (with their router gaps) and re-rank of
    the requests ``picks`` (``tf32``: its products in TF32, the
    control)."""
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
                out.append(ref_switch.retrieve(
                    w, m, ecfg, store, trie, cid_map,
                    torch.as_tensor(ids[j], device=dev),
                    torch.as_tensor(mask[j], device=dev), max_len))
    finally:
        ref_model.f32_matmul_only()
    return out, {tuple(int(x) for x in c.split("-")) for c in cid_map}


def _one(served: dict, beams, rr, q: int):
    """Query ``q`` of a retrieve alone: its served arrays, beams and
    re-rank."""
    prog = {k: v[q:q + 1] for k, v in served.items()
            if k in ("sequences", "beam_scores", "valid")}
    prog.update({k: served[k][:, q:q + 1] for k in ("doc_ids", "fused")})
    return prog, ref_serve.Beams([beams.cids[q]], [beams.scores[q]],
                                 beams.cut_gap[q:q + 1]), ref_serve.Reranked(
        rr.doc_ids[:, q:q + 1], rr.fused[:, q:q + 1], [rr.sim[q]],
        [rr.prob[q]])


def numbers(served: list[dict], refs, kary: int, alphas, cids
            ) -> tuple[dict, dict]:
    """The compared numbers of ``served`` answers against the reference's
    ``refs`` [(beams, re-rank)], query by query: a query with a router tie
    keeps only ``malformed`` (its beams read as at a beam tie); and what
    was left out."""
    parts, tied = [], 0
    for prog, (beams, rr) in zip(served, refs):
        for q in range(len(beams.cids)):
            p, bq, rq = _one(prog, beams, rr, q)
            if beams.route_gap[q] < ROUTE_TIE_GAP:
                tied += 1
                bq.cut_gap = np.zeros(1)
                got = compare.serve_numbers(p, bq, rq, kary, alphas, cids)
                got = {**dict.fromkeys(got, 0), "queries": 1,
                       "malformed": got["malformed"]}
            else:
                got = compare.serve_numbers(p, bq, rq, kary, alphas, cids)
            parts.append(got)
    got = compare.merge(parts)
    got["route_tie_share"] = tied / max(got["queries"], 1)
    return got, {"compared_queries": got["queries"],
                 "tie_excluded": got["tie_excluded"], "route_tied": tied}


def check(ctx, ids, mask, outs, max_len) -> tuple[dict, dict]:
    """Each compared number beside its limit, and what the comparison
    left out."""
    tr, m = ctx.traffic, ctx.config["model"]
    picks = sample(ctx, len(outs), mask)
    t = time.perf_counter()
    refs, cids = reference_outputs(ctx, ids, mask, picks, max_len)
    got, info = numbers([outs[j] for j in picks], refs, m["kary"],
                        ctx.config["eval"]["score_rates"], cids)
    checks = {k: (got[k], tr["limits"][k]) for k in CHECKS}
    gaps = np.concatenate([b.route_gap for b, _ in refs])
    return checks, {**info, "route_gap_min": float(gaps.min()),
                    "reference_s": time.perf_counter() - t}
