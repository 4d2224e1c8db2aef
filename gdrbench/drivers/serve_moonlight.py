"""Serving on a decoder-only DeepSeek-V3 generator (Moonlight-16B-A3B):
``drivers/serve.py``'s closed loop of one caller over
``Evaluator.retrieve`` (the packed float32 path), its world, sample and
served arrays, and ``serve_switch.py``'s set-up parts and per-query
split, with what the stack changes:

- the weights: the model is built on the card and its parameters drawn in
  place from the seed (``weights_moonlight.py``); the plain reference then
  reads those same tensors, so the ~62.5 GB of the stack exist once;
- the set-up's launch check: ``mla_attention`` ``layers × steps`` times,
  ``topk_expert_sublayer`` at every expert layer once for the prefill and
  once a step, one packed scorer;
- the traced stretch starts from zeroed counters and reads the routing
  counters after it, for the experts' bound (``costs_moonlight.py``);
- ``correct``: the plain reference is ``reference/moonlight.py``, which
  follows the program's routing where its own k-th and (k+1)-th selection
  scores lie within its ``ROUTE_TIE_GAP`` (every query is compared).  The
  program's chosen experts of every token of each compared retrieve are
  recorded by running it again eagerly (the replayed graphs compute the
  same bits: ``tests/test_torch_cuda_moonlight.py``), keyed by the
  token's query position or its beam's CID inputs.  Besides the serving
  numbers, ``route_refused`` counts the program's sets that differ from
  the reference's outside the gap, and ``selection_err`` is the largest
  |program − reference| selection score over the first compared query's
  tokens at every expert layer, which must stay under a tenth of the gap;
  ``info`` reports ``route_follow_share`` (decisions followed over all).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from gdrbench import compare, costs_moonlight, trace
from gdrbench.drivers.serve import (SEED_QUERIES, SEED_STORE, SEED_WEIGHTS,
                                    _host, _world, sample)
from gdrbench.drivers.serve_switch import _one
from gdrbench.reference import model as ref_model
from gdrbench.reference import moonlight as ref_ds
from gdrbench.reference import serve as ref_serve
from gdrbench.traffic.world import queries, sub_seed, unit_store
from gdrbench.weights_moonlight import draw_into

CHECKS = compare.SERVE_NUMBERS + ("route_refused", "selection_err")


def expected_launches(m: dict, max_len: int) -> dict[str, int]:
    """Kernel launches of one retrieve on the main path."""
    moe = m["num_layers"] - m["first_k_dense"]
    return {"mla_attention": m["num_layers"] * max_len,
            "topk_expert_sublayer": moe * (max_len + 1), "packed_scores": 1}


def build(ctx):
    """(model, its parameters by name) on the run's device."""
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever

    with ctx.device:
        model = GenerativeRetriever(ModelConfig(**ctx.config["model"]))
    return model.eval(), draw_into(model, sub_seed(ctx.seed, SEED_WEIGHTS))


def run(ctx) -> dict:
    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import EvalConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
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
    part("start")
    cid_map, max_len = _world(ctx)
    trie = build_trie(cid_map, st["kary"],
                      max_docs_per_cluster=st["max_docs_per_cluster"])
    store = unit_store(st["n_docs"], m["encoder_d_model"],
                       sub_seed(ctx.seed, SEED_STORE), dev)
    part("world")
    model, w = build(ctx)
    part("weights")
    ev = Evaluator(model, trie, store, EvalConfig(**ecfg),
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
             "flops_per_unit": costs_moonlight.retrieve_flops(
                 m, b, ecfg["num_beams"], max_len, s,
                 st["n_docs"] / len(cid_map)),
             "peak_flops": costs_moonlight.H100_F32_FLOPS,
             "mla_bound_s_per_unit": costs_moonlight.mla_bound_s(
                 m, b, ecfg["num_beams"], max_len, s)}
    if ctx.trace:
        k = tr["trace_requests"]

        def traced_requests():
            for j in range(n, n + k):
                _host(*ev.retrieve(ids[j % pool], mask[j % pool]))
        kernels.reset_launch_counts()
        layer["trace"] = trace.traced(traced_requests)
        layer["trace_units"] = k
        routing = kernels.launch_counts(experts=True)
        layer["topk_expert_bound_s"] = costs_moonlight.topk_expert_bound_s(
            m, routing)
        info["routing_traced"] = {name: v for name, v in routing.items()
                                  if name.startswith("moe_")}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    reps = np.arange(n) % pool
    picks = sample(ctx, n, mask[reps])
    routes = [program_routes(model, ev, ids[reps[j]], mask[reps[j]])
              for j in picks]
    del ev
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, checked = check(ctx, w, ids[reps], mask[reps], outs, picks,
                            routes, max_len)
    return {"attempted": n * b, "failed": 0,
            "end_to_end": {"setup_s": setup_s,
                           "retrieve_p95_ms": float(np.percentile(lat, 95))
                           * 1e3,
                           "queries_per_s": n * b / window_s},
            "layer": layer, "memory_peak_bytes": peak, "checks": checks,
            "info": {**checked, **info, "retrieves": n,
                     "retrieve_p50_ms": float(np.percentile(lat, 50)) * 1e3}}


@torch.no_grad()
def program_routes(model, ev, ids, mask) -> dict:
    """The program's chosen experts and router logits of every token of
    one retrieve, run again eagerly: (layer, (query, key)) → (experts,
    logits), key ("p", l) for query position l and the tuple of the beam's
    CID inputs for a CID position."""
    from gdr_tpu_torch.models.deepseek import MoE
    from gdr_tpu_torch.ops.beam import generate_cids

    layers = {i: blk.ff for i, blk in enumerate(model.stack.blocks)
              if isinstance(blk.ff, MoE)}
    for ff in layers.values():
        ff.record = []
    inputs = []
    step = model.decode_step_candidates

    def recorded(token, cache, enc_mask, pos, num_beams=1,
                 return_hidden=False):
        prev = cache.get("route_inputs")
        cur = token.long()[:, None]
        seq = cur if prev is None else torch.cat([prev, cur], dim=1)
        out = step(token, cache, enc_mask, pos, num_beams, return_hidden)
        out[-1]["route_inputs"] = seq          # reordered with the beams
        inputs.append(seq.cpu().tolist())
        return out

    ids_t = torch.as_tensor(ids, device=ev.device)
    mask_t = torch.as_tensor(mask, device=ev.device)
    model.decode_step_candidates = recorded
    try:
        generate_cids(model, ids_t, mask_t, ev._children, ev._eos,
                      ev.cfg.num_beams, ev._max_len, ev.cfg.length_penalty,
                      u_table=ev._u_table)
        calls = {i: [(r.cpu(), z.cpu()) for r, z in ff.record]
                 for i, ff in layers.items()}
    finally:
        del model.decode_step_candidates
        for ff in layers.values():
            ff.record = None
    b, s = ids.shape
    lens = mask.sum(1)
    out = {}
    for i, recs in calls.items():
        route, z = recs[0]                               # the prefill
        for q in range(b):
            for pos in range(int(lens[q])):
                out[i, (q, ("p", pos))] = (route[q * s + pos].tolist(),
                                           z[q * s + pos])
        for seqs, (route, z) in zip(inputs, recs[1:]):
            per = len(seqs) // b
            for r, seq in enumerate(seqs):
                out[i, (r // per, tuple(seq))] = (route[r].tolist(), z[r])
    return out


def selection_err(w, m: dict, ids, mask, routes: dict) -> float:
    """The largest |program − reference| selection score (sigmoid + bias)
    over query 0's tokens at every expert layer, the reference following
    the program's routing."""
    n = int(mask[0].sum())
    dev = w["shared.weight"].device
    x = w["shared.weight"][torch.as_tensor(ids[0, :n], device=dev).long()]
    scores: list = []
    with torch.no_grad():
        ref_ds.stack(w, m, x[None], lambda _, l: (0, ("p", l)),
                     _follow(routes), ref_ds.Routing(), scores)
    err = 0.0
    first = m["first_k_dense"]
    for j, ref in enumerate(scores):
        i = first + j
        bias = w[f"stack.blocks.{i}.ff.score_bias"].detach().cpu()
        prog = torch.stack([routes[i, (0, ("p", l))][1] for l in range(n)])
        err = max(err, float((torch.sigmoid(prog) + bias
                              - ref.cpu()).abs().max()))
    return err


def _follow(routes: dict):
    def follow(layer, key):
        got = routes.get((layer, key))
        return None if got is None else got[0]
    return follow


def reference_outputs(ctx, w, ids, mask, picks, routes, max_len,
                      tf32: bool = False, logs=None):
    """The plain reference's beams (with their routing counts) and re-rank
    of the requests ``picks``, following ``routes`` (None: its own
    routing; ``tf32``: its products in TF32, the control, whose decisions
    near ties go to ``logs``)."""
    cfg, dev = ctx.config, ctx.device
    m, st, ecfg = cfg["model"], cfg["store"], cfg["eval"]
    cid_map, _ = _world(ctx)
    ref_model.f32_matmul_only()
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        store = unit_store(st["n_docs"], m["encoder_d_model"],
                           sub_seed(ctx.seed, SEED_STORE), dev)
        trie = ref_serve.Trie(cid_map, m["kary"])
        out = []
        with torch.no_grad():
            for i, (j, r) in enumerate(zip(picks, routes)):
                out.append(ref_ds.retrieve(
                    w, m, ecfg, store, trie, cid_map,
                    torch.as_tensor(ids[j], device=dev),
                    torch.as_tensor(mask[j], device=dev), max_len,
                    None if r is None else _follow(r),
                    None if logs is None else logs[i]))
    finally:
        ref_model.f32_matmul_only()
    return out, {tuple(int(x) for x in c.split("-")) for c in cid_map}


def numbers(served: list[dict], refs, kary: int, alphas, cids
            ) -> tuple[dict, dict]:
    """The compared numbers of ``served`` answers against the reference's
    ``refs`` [(beams, re-rank)], query by query, and the routing counts."""
    parts = []
    routing = ref_ds.Routing()
    for prog, (beams, rr) in zip(served, refs):
        routing.add(beams.routing)
        for q in range(len(beams.cids)):
            parts.append(compare.serve_numbers(*_one(prog, beams, rr, q),
                                               kary, alphas, cids))
    got = compare.merge(parts)
    got["route_refused"] = routing.refused
    return got, {"compared_queries": got["queries"],
                 "tie_excluded": got["tie_excluded"],
                 "route_decisions": routing.decisions,
                 "route_near": routing.near,
                 "route_followed": routing.followed,
                 "route_unmatched": routing.unmatched,
                 "route_follow_share": routing.followed
                 / max(routing.decisions, 1),
                 "route_gap_min": routing.min_gap}


def check(ctx, w, ids, mask, outs, picks, routes, max_len
          ) -> tuple[dict, dict]:
    """Each compared number beside its limit, and what the comparison
    counted."""
    tr, m = ctx.traffic, ctx.config["model"]
    t = time.perf_counter()
    refs, cids = reference_outputs(ctx, w, ids, mask, picks, routes, max_len)
    got, info = numbers([outs[j] for j in picks], refs, m["kary"],
                        ctx.config["eval"]["score_rates"], cids)
    ref_model.f32_matmul_only()
    got["selection_err"] = selection_err(w, m, ids[picks[0]],
                                         mask[picks[0]], routes[0])
    checks = {k: (got[k], tr["limits"][k]) for k in CHECKS}
    return checks, {**info, "reference_s": time.perf_counter() - t}
