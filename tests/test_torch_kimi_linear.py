"""The port's Kimi Linear generator on the CPU (its plain versions), at the
preset ``kimi-linear-tiny`` (d 64, one period: a KDA layer with the dense
FFN, two KDA and one NoPE MLA layer with 16 experts top-4, 8 held, KDA
heads of 16), against the benchmark's plain reference
(``gdrbench/reference/kimi_linear.py``):

- a KDA layer's prefill and decode steps, the beams reordered between
  steps, against the reference's token-by-token recurrence over each
  row's whole sequence;
- the two-buffer reorder (a step reads its rows' states at their source)
  against gathering the states first;
- the stack's cached decode against the reference's full forward, step by
  step, comparing candidate logits; a whole ``Evaluator.retrieve``
  against the reference's beams, scores and top-R;
- the chip's share of the expert layer: the held parts of all the shares,
  with the shared expert counted once, add up to the uncut layer, in the
  port and in the reference; the whole share is the layer as before, bit
  for bit;
- latent attention without rotation;
- the counters ``moe_held``, ``kda_state_rows``, ``kda_source_rows`` and
  ``kda_prefill_tokens`` (and the rows a chunk that
  ``tools/serve_spans.py`` reads from them); the published preset.

The file imports neither JAX nor the JAX package."""

from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from gdr_tpu_torch import kernels
from gdr_tpu_torch.config import EvalConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.kernels import experts, kda, mla
from gdr_tpu_torch.kernels.decode import _mm, _rms
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.models.kimi_linear import KDAttention
from gdr_tpu_torch.ops.beam import _reorder_cache
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.utils import timing
from gdrbench import compare
from gdrbench.reference import kimi_linear as ref
from gdrbench.reference import model as M
from gdrbench.reference import moonlight as ref_ds
from gdrbench.reference import serve as ref_serve
from gdrbench.traffic.world import bench_cid_map, unit_store

TOL = 1e-5      # f32 in another summation order, through four layers
BASE = ModelConfig(kary=4, max_output_length=5, adaptor_layer_num=1,
                   adaptor_num_heads=2, encoder_d_model=16, dropout_rate=0.0)
TINY = BASE.scaled("kimi-linear-tiny")


def _model(seed: int = 0, **over) -> GenerativeRetriever:
    torch.manual_seed(seed)
    model = GenerativeRetriever(dataclasses.replace(TINY, **over))
    return init_weights(model, torch.Generator().manual_seed(seed)).eval()


def _cfg(model) -> dict:
    return dataclasses.asdict(model.cfg)


def _queries(batch: int, seq: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(2, TINY.vocab_size, (batch, seq), generator=g)
    mask = torch.ones_like(ids)
    mask[-1, seq - 3:] = 0                       # one query with padding
    return ids * mask, mask


def _sources(batch: int, beams: int, g) -> torch.Tensor:
    """A beam step's source rows: each row a beam of its own query."""
    return (torch.arange(batch)[:, None] * beams
            + torch.randint(0, beams, (batch, beams), generator=g)
            ).reshape(-1)


# ------------------------------------------------------------------ KDA

def test_kda_layer_decode_matches_the_full_recurrence():
    """Layer 1 (a KDA layer): the prefill over two queries (one padded),
    then four decode steps of three beam rows a query, the beams reordered
    after each step; each row's output equals the reference's KDA over the
    query's real tokens and the row's own inputs, token by token."""
    model = _model()
    w, cfg = dict(model.state_dict()), _cfg(model)
    blk = model.stack.blocks[1]
    assert isinstance(blk.attn, KDAttention)
    p, d, beams, steps = "stack.blocks.1.", TINY.d_model, 3, 4
    g = torch.Generator().manual_seed(1)
    b, s = 2, 7
    xq = torch.randn(b, s, d, generator=g)
    lens = torch.tensor([7, 4], dtype=torch.int32)
    geo = dict(batch=b, seq=s, lens=lens)
    cache: dict = {}
    hist = [[xq[r // beams, :int(lens[r // beams])]] for r in range(b * beams)]
    with torch.no_grad():
        got = blk.attn.prefill(1, blk.ln1, xq.reshape(b * s, d), geo, None,
                               cache)
        want = ref.kda(w, p, cfg, M.rms_norm(xq[:1], blk.ln1.scale, 1e-5))
        assert float((got.view(b, s, d)[:1] - xq[:1] - want).abs().max()) \
            < TOL
        for pos in range(steps):
            x = torch.randn(b * beams, d, generator=g)
            out = blk.attn.decode(1, blk.ln1, x, cache, pos, beams, None)
            for r in range(b * beams):
                seq = torch.cat(hist[r] + [x[r:r + 1]])
                h = M.rms_norm(seq[None], blk.ln1.scale, 1e-5)
                want = ref.kda(w, p, cfg, h)[0, -1]
                assert float((out[r] - x[r] - want).abs().max()) < TOL, pos
                hist[r] = hist[r] + [x[r:r + 1]]
            src = _sources(b, beams, g)
            cache = _reorder_cache(cache, src)
            hist = [hist[j] for j in src.tolist()]
    assert cache["rec_src"].dtype == torch.int32


@pytest.mark.parametrize("n_in", [2, 6])
def test_two_buffer_reorder_equals_gathering_the_state(n_in):
    """A decode step that reads each row's state and window at its source
    row gives the bits of one that reads them gathered first; without
    sources, the n input rows are shared by R / n rows each."""
    g = torch.Generator().manual_seed(n_in)
    heads, dk, r = 2, 16, 6
    qkv = torch.randn(r, 3 * heads * dk, generator=g)
    fgb = torch.randn(r, 2 * dk + heads, generator=g)
    w = (0.1 * torch.randn(heads * dk, dk, generator=g),
         0.1 * torch.randn(heads * dk, dk, generator=g),
         0.5 * torch.randn(3 * heads * dk, 4, generator=g),
         torch.randn(heads, generator=g), torch.randn(heads * dk, generator=g),
         1 + 0.1 * torch.randn(dk, generator=g))
    s_in = torch.randn(n_in, heads, dk, dk, generator=g)
    c_in = torch.randn(n_in, 3, 3 * heads * dk, generator=g)
    src = torch.randint(0, n_in, (r,), generator=g, dtype=torch.int32)

    def step(s0, c0, source):
        so, co = torch.empty(r, heads, dk, dk), torch.empty(r, 3, c0.shape[2])
        o = kda.kda_decode(qkv, fgb, *w, s0, c0, source, so, co, heads=heads,
                           eps=1e-5)
        return o, so, co
    got = step(s_in, c_in, src)
    want = step(s_in[src.long()], c_in[src.long()], None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    shared = step(s_in, c_in, None)
    rep = torch.arange(r) * n_in // r
    gathered = step(s_in[rep], c_in[rep], None)
    assert all(torch.equal(a, b) for a, b in zip(shared, gathered))
    s_own, c_own = torch.empty(r, heads, dk, dk), torch.empty(r, 3, c_in.shape[2])
    with pytest.raises(ValueError, match="two buffers"):
        kda.kda_decode(qkv, fgb, *w, s_own, c_own, None, s_own, c_own,
                       heads=heads, eps=1e-5)


def test_kda_prefill_keeps_the_last_real_tokens_window():
    """The prefix window holds the raw inputs of the query's last three
    real tokens (zeros before the first); pads give o = 0 and leave the
    state as after the last real token."""
    g = torch.Generator().manual_seed(3)
    heads, dk, s = 2, 16, 6
    qkv = torch.randn(2 * s, 3 * heads * dk, generator=g)
    fgb = torch.randn(2 * s, 2 * dk + heads, generator=g)
    w = (0.1 * torch.randn(heads * dk, dk, generator=g),
         0.1 * torch.randn(heads * dk, dk, generator=g),
         0.5 * torch.randn(3 * heads * dk, 4, generator=g),
         torch.randn(heads, generator=g), torch.randn(heads * dk, generator=g),
         torch.ones(dk))
    lens = torch.tensor([6, 2], dtype=torch.int32)
    o, state, conv = kda.kda_prefill(qkv, fgb, *w, lens, batch=2,
                                     heads=heads, eps=1e-5)
    assert torch.equal(conv[0], qkv[3:6]) and not conv[1, 0].any()
    assert torch.equal(conv[1, 1:], qkv[s:s + 2])
    assert not o[s + 2:].any()
    o2, state2, _ = kda.kda_prefill(qkv[s:s + 2], fgb[s:s + 2], *w,
                                    lens[1:], batch=1, heads=heads, eps=1e-5)
    assert torch.equal(state2[0], state[1]) and torch.equal(o2, o[s:s + 2])


# ---------------------------------------------------------------- stack

def test_cached_decode_matches_the_full_sequence_reference():
    """Each step's candidate logits of the cached decode, three beam rows a
    query, the beams reordered after each step as the search reorders
    them, equal the reference's stack recomputed over the query and the
    row's CID inputs."""
    model = _model()
    w, cfg = dict(model.state_dict()), _cfg(model)
    ids, mask = _queries(2, 10, 2)
    beams, steps = 3, 5
    g = torch.Generator().manual_seed(4)
    tokens = torch.zeros((2 * beams, steps), dtype=torch.long)
    for p in range(1, steps):
        tokens[:, p] = (p - 1) * TINY.kary + 2 + torch.randint(
            0, TINY.kary, (2 * beams,), generator=g)
    with torch.no_grad():
        enc, prefix = model.prefill(ids, mask)
        cache = model.init_cache(enc, steps, beams, prefix)
        cache["cross_ucand"] = model.decode_tables(steps)
        for pos in range(steps):
            got, cache = model.decode_step_candidates(
                tokens[:, pos].int(), cache, mask, pos, beams)
            inputs = tokens[:, :pos + 1]
            with ref._this_stack():
                hid = ref_ds.decode(w, cfg, inputs, ids, mask)[:, pos]
            ada = M.pawa(w, cfg, inputs)[:, pos]
            want = M.candidate_logits(w, cfg, hid, ada, pos)
            assert float((got - want).abs().max()) < TOL, pos
            src = _sources(2, beams, g)
            cache = _reorder_cache(cache, src)
            tokens = tokens[src]


def test_retrieve_matches_the_reference():
    """A whole ``Evaluator.retrieve`` (packed store, beam 8, two queries,
    one padded): the reference's beams, scores and fused scores."""
    model = _model(seed=1)
    w, cfg = dict(model.state_dict()), _cfg(model)
    cid_map = bench_cid_map(200, 4, 4)
    trie = build_trie(cid_map, 4, max_docs_per_cluster=4)
    store = unit_store(200, 16, 9, "cpu")
    ecfg = dict(num_beams=8, num_return_sequences=8, max_output_length=5,
                length_penalty=0.8, score_rates=[0.0, 1.0, 2.5])
    ev = Evaluator(model, trie, store.numpy(), EvalConfig(**ecfg),
                   packed=True)
    ids, mask = _queries(2, 10, 3)
    res, rr = ev.retrieve(ids.numpy(), mask.numpy())
    served = {"doc_ids": rr.doc_ids.numpy(), "fused": rr.scores.numpy(),
              "sequences": res.sequences.numpy(),
              "beam_scores": res.scores.numpy(), "valid": res.valid.numpy()}
    max_len = min(5, max(len(c.split("-")) for c in cid_map) + 1)
    with torch.no_grad():
        beams, ref_rr = ref.retrieve(
            w, cfg, ecfg, store, ref_serve.Trie(cid_map, 4), cid_map, ids,
            mask, max_len)
    cids = {tuple(int(x) for x in c.split("-")) for c in cid_map}
    got = compare.serve_numbers(served, beams, ref_rr, 4, ecfg["score_rates"],
                                cids)
    assert got["malformed"] == got["beam_set_diff"] == 0
    assert got["beam_score_err"] < TOL and got["fused_err"] < TOL
    assert beams.routing.decisions > 0 and beams.routing.refused == 0


# ------------------------------------------------------------ the share

def _expert_layer(seed: int, n_exp=16, d=64, f=32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(12, d, generator=g)
    return (x, x + 0.1 * torch.randn(12, d, generator=g),
            1 + 0.1 * torch.randn(d, generator=g),
            0.3 * torch.randn(n_exp, d, generator=g),
            0.1 * torch.randn(n_exp, generator=g),
            0.1 * torch.randn(n_exp, 2 * f, d, generator=g),
            0.1 * torch.randn(n_exp, d, f, generator=g))


def test_the_shares_add_up_to_the_uncut_layer():
    """Eight cards of two experts each: the held parts of their outputs,
    with the shared expert (in ``base``) counted once, add up to the whole
    layer's, in the port's plain version and in the reference."""
    x, base, scale, router, bias, wi, wo = _expert_layer(0)
    kw = dict(k=4, scale=2.446, eps=1e-5)
    whole = experts.topk_expert_sublayer(x, base, scale, router, bias, wi,
                                         wo, **kw)
    total = base.clone()
    for off in range(0, 16, 2):
        part = experts.topk_expert_sublayer(
            x, base, scale, router, bias, wi[off:off + 2], wo[off:off + 2],
            offset=off, **kw)
        total += part - base
    assert float((total - whole).abs().max()) < TOL
    cfg = dict(num_experts_per_tok=4, routed_scaling_factor=2.446)
    h = _rms(x, scale, 1e-5)[None]
    p = "l."
    w = {p + "ff.router": router, p + "ff.score_bias": bias,
         p + "ff.wi": wi, p + "ff.wo": wo}
    r = ref.Routing()
    with torch.no_grad():
        full = ref_ds.routed(w, p, cfg, h, 1, None, None, r)
        parts = sum(ref_ds.routed(ref._share(
            {**w, p + "ff.wi": wi[o:o + 2], p + "ff.wo": wo[o:o + 2]}, p,
            {**cfg, "expert_offset": o}), p, cfg, h, 1, None, None, r)
            for o in range(0, 16, 2))
    assert float((parts - full).abs().max()) < TOL
    assert float((full[0] + base - whole).abs().max()) < TOL


def _topk_before(x, base, ln_scale, router, bias, wi, wo, *, k, scale, eps):
    """The top-k sublayer's plain version before the share: every expert
    held."""
    r, d = x.shape
    dff = wi.shape[1] // 2
    h = _rms(x, ln_scale, eps)
    sel, w = experts.topk_select(_mm(h, router), bias, k, scale)
    y = torch.zeros((r, k, d))
    for e in torch.unique(sel).tolist():
        rows, slot = (sel == e).nonzero(as_tuple=True)
        gu = _mm(h[rows], wi[e])
        y[rows, slot] = _mm(F.silu(gu[:, :dff]) * gu[:, dff:], wo[e])
    out = base.float()
    for j in range(k):
        out = out + w[:, j:j + 1] * y[:, j]
    return out


@pytest.mark.parametrize("widths", [(64, 2048, 1408, 6), (128, 768, 3072, 2)],
                         ids=["moonlight", "switch-top2"])
def test_the_whole_share_is_the_layer_as_before(widths):
    """At Moonlight's and Switch's widths (a few rows), the layer that holds
    all its experts gives the bits of the plain version before the share,
    and counts every assignment as held."""
    e, d, f, k = widths
    g = torch.Generator().manual_seed(e)
    x = torch.randn(3, d, generator=g)
    args = (x, x + 0.1, torch.ones(d), 0.02 * torch.randn(e, d, generator=g),
            0.01 * torch.randn(e, generator=g),
            0.02 * torch.randn(e, 2 * f, d, generator=g),
            0.02 * torch.randn(e, d, f, generator=g))
    kernels.reset_launch_counts()
    got = experts.topk_expert_sublayer(*args, k=k, scale=2.446, eps=1e-5)
    stats = kernels.launch_counts(experts=True)
    assert torch.equal(got, _topk_before(*args, k=k, scale=2.446, eps=1e-5))
    assert stats["moe_held"] == stats["moe_assignments"] == 3 * k
    assert experts.MAX_D >= 2304


# ------------------------------------------------------------------ MLA

def test_mla_without_rotation_takes_the_rope_columns_as_they_are():
    """NoPE latent attention: the cached key's rope columns are k_pe
    unrotated, and the output is softmax(scale · q·k) · v over the prefix
    and the row's steps."""
    g = torch.Generator().manual_seed(0)
    b, w_, h, s, lmax, pos = 1, 2, 2, 5, 3, 1
    q = torch.randn(b * w_, h * 24, generator=g)
    kva = torch.randn(b * w_, 40, generator=g)
    kvb = torch.randn(b * w_, h * 32, generator=g)
    pk = torch.randn(b, h, s, 24, generator=g)
    pv = torch.randn(b, h, s, 16, generator=g)
    ck = torch.randn(lmax, b * w_, h, 24, generator=g)
    cv = torch.randn(lmax, b * w_, h, 16, generator=g)
    inv = mla.rope_inv_freq(8, 10000.0)
    out = mla.mla_attention(q, kva, kvb, pk, pv, torch.zeros(b, s),
                            torch.tensor([s], dtype=torch.int32), ck, cv,
                            pos, inv, w_, scale=24 ** -0.5, rotate=False)
    assert torch.equal(ck[pos, :, 1, 16:], kva[:, 32:])
    keys = torch.cat([pk[0][None].expand(w_, -1, -1, -1),
                      ck[:pos + 1].permute(1, 2, 0, 3)], dim=2)
    vals = torch.cat([pv[0][None].expand(w_, -1, -1, -1),
                      cv[:pos + 1].permute(1, 2, 0, 3)], dim=2)
    att = torch.softmax(torch.einsum("rhd,rhsd->rhs", q.view(w_, h, 24),
                                     keys) * 24 ** -0.5, dim=-1)
    want = torch.einsum("rhs,rhsd->rhd", att, vals).reshape(w_, h * 16)
    assert float((out - want).abs().max()) < 1e-6


# ------------------------------------------------------------- counters

def test_the_held_and_state_row_counters():
    """A retrieve of beam 8 over a 3-level trie: ``kda_state_rows`` counts
    the rows of every KDA decode call (widths 1, 5, 8, 8 a step, three KDA
    layers), ``moe_held`` the assignments that fell to the 8 held experts
    of the 16, the same as the route records give."""
    model = _model(seed=2, expert_offset=4)
    cid_map = bench_cid_map(200, 4, 4)
    ev = Evaluator(model, build_trie(cid_map, 4, max_docs_per_cluster=4),
                   unit_store(200, 16, 9, "cpu").numpy(),
                   EvalConfig(num_beams=8, num_return_sequences=8,
                              max_output_length=5), packed=True)
    moes = [blk.ff for blk in model.stack.blocks[1:]]
    for ff in moes:
        ff.record = []
    ids, mask = _queries(1, 8, 5)
    kernels.reset_launch_counts()
    ev.retrieve(ids.numpy(), mask.numpy())
    stats = kernels.launch_counts(experts=True)
    assert timing.counts()["kda_state_rows"] == 3 * (1 + 5 + 8 + 8)
    assert "kda_state_rows" not in kernels.launch_counts()
    routes = torch.cat([r.reshape(-1) for ff in moes for r, _ in ff.record])
    assert stats["moe_assignments"] == routes.numel()
    assert stats["moe_held"] == int(((routes >= 4) & (routes < 12)).sum())
    assert 0 < stats["moe_held"] < stats["moe_assignments"]
    for ff in moes:
        ff.record = None


def test_the_source_row_and_prefill_token_counters():
    """``kda_source_rows`` counts the distinct rows a decode call read
    (given sources, or n inputs shared by R / n rows each),
    ``kda_prefill_tokens`` the real tokens a prefill ran; a retrieve's
    prefills run its query's real tokens at every KDA layer, and its
    decode calls read no more sources than they wrote rows."""
    g = torch.Generator().manual_seed(4)
    heads, dk, r = 2, 16, 6
    qkv = torch.randn(r, 3 * heads * dk, generator=g)
    fgb = torch.randn(r, 2 * dk + heads, generator=g)
    w = (0.1 * torch.randn(heads * dk, dk, generator=g),
         0.1 * torch.randn(heads * dk, dk, generator=g),
         0.5 * torch.randn(3 * heads * dk, 4, generator=g),
         torch.randn(heads, generator=g), torch.randn(heads * dk, generator=g),
         1 + 0.1 * torch.randn(dk, generator=g))
    kernels.reset_launch_counts()
    for n_in, src in ((3, torch.tensor([0, 0, 2, 2, 2, 1],
                                       dtype=torch.int32)),
                      (2, None), (6, torch.tensor([5, 5, 5, 5, 5, 5],
                                                  dtype=torch.int32))):
        s_in = torch.randn(n_in, heads, dk, dk, generator=g)
        c_in = torch.randn(n_in, 3, 3 * heads * dk, generator=g)
        kda.kda_decode(qkv, fgb, *w, s_in, c_in, src,
                       torch.empty(r, heads, dk, dk),
                       torch.empty(r, 3, 3 * heads * dk), heads=heads,
                       eps=1e-5)
    kda.kda_prefill(qkv, fgb, *w, torch.tensor([2, 3], dtype=torch.int32),
                    batch=2, heads=heads, eps=1e-5)
    got = kernels.launch_counts(experts=True)
    assert (got["kda_source_rows"], got["kda_prefill_tokens"]) == \
        (3 + 2 + 1, 2 + 3)
    assert timing.counts()["kda_state_rows"] == 3 * r
    kernels.reset_launch_counts()
    assert kernels.launch_counts(experts=True)["kda_source_rows"] == 0

    model = _model(seed=3)
    cid_map = bench_cid_map(200, 4, 4)
    ev = Evaluator(model, build_trie(cid_map, 4, max_docs_per_cluster=4),
                   unit_store(200, 16, 9, "cpu").numpy(),
                   EvalConfig(num_beams=8, num_return_sequences=8,
                              max_output_length=5), packed=True)
    ids, mask = _queries(2, 8, 6)
    kernels.reset_launch_counts()
    ev.retrieve(ids.numpy(), mask.numpy())
    got = kernels.launch_counts(experts=True)
    assert got["kda_prefill_tokens"] == 3 * int(mask.sum())
    # step 0 reads each query's prefix state, step 1 the one beam's
    assert 3 * 2 * 2 < got["kda_source_rows"] \
        < timing.counts()["kda_state_rows"] == 3 * 2 * (1 + 5 + 8 + 8)


def test_the_span_tool_reads_rows_a_chunk_of_the_held_assignments():
    """``tools/serve_spans.py``: only the held experts' assignments are
    grouped into chunks, so a chunk's rows are ``moe_held / moe_chunks``;
    a checkout that counts no ``moe_held`` holds every expert."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools/serve_spans.py"
    spec = importlib.util.spec_from_file_location("serve_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    share = {"info": {"routing_traced": {
        "moe_assignments": 800, "moe_held": 100, "moe_chunks": 25}}}
    whole = {"info": {"routing_traced": {
        "moe_assignments": 600, "moe_chunks": 100}}}
    assert tool.rows_a_chunk(share) == 4.0
    assert tool.held_share(share) == 0.125
    assert tool.rows_a_chunk(whole) == 6.0
    assert tool.held_share(whole) is None
    assert tool.rows_a_chunk({"info": {}}) is None


# ---------------------------------------------------------------- shape

def test_the_published_preset():
    """Kimi-Linear-48B-A3B at card 0's share: 20 KDA and 7 MLA layers, the
    router over 256 experts, 32 held; ~1.26 B parameters besides the held
    experts and the embeddings."""
    c = BASE.scaled("kimi-linear-48b-a3b")
    assert c.decoder_only and c.n_held == 32 and c.num_experts == 256
    assert sum(map(c.is_kda, range(27))) == 20
    assert [i + 1 for i in range(27) if not c.is_kda(i)] \
        == list(c.full_attn_layers)
    with torch.device("meta"):
        model = GenerativeRetriever(c)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["stack.blocks.0.attn.qkv.weight"] == (12288, 2304)
    assert shapes["stack.blocks.0.attn.fgb.weight"] == (288, 2304)
    assert shapes["stack.blocks.3.attn.q_proj.weight"] == (6144, 2304)
    assert shapes["stack.blocks.1.ff.router"] == (256, 2304)
    assert shapes["stack.blocks.1.ff.wi"] == (32, 2048, 2304)
    assert shapes["stack.blocks.0.ff.wi.weight"] == (18432, 2304)
    held = sum(p.numel() for name, p in model.named_parameters()
               if name.endswith((".ff.wi", ".ff.wo")))
    stack = sum(p.numel() for name, p in model.named_parameters()
                if name.startswith("stack."))
    assert held == 26 * 32 * 3 * 2304 * 1024
    assert 1.2e9 < stack - held < 1.3e9
    assert not GenerativeRetriever(TINY).cfg.is_kda(3)
