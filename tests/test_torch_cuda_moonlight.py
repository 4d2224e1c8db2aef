"""The decoder-only DeepSeek-V3 path on the card: the top-k expert kernels
(``csrc/experts.cu``) and the MLA decode kernel (``csrc/mla.cu``) against
their plain versions, the f32 GEMM at the stack's shapes, the program's
selection scores against the plain reference at the published widths, and
a retrieve replayed as CUDA graphs against the same retrieve run eagerly.
Every test needs a CUDA device (``cuda`` marker; they skip without one).

- Top-k experts at Moonlight's widths (64 experts, d 2,048, d_ff 1,408,
  top-6, routers N(0, 0.02²), biases N(0, 0.01²)) and at Switch-Base's (128
  experts, d 768, d_ff 3,072, top-1 and top-2), at 1, 31, 40, 100 and
  1,280 rows: the same chosen experts as the plain version given the
  kernel's own logits (logits within ``LOGIT_TOL``), the counters, and
  the output within ``OUT_TOL`` of the plain products on cuBLAS with
  TF32 off; a second call gives the same bits, and so does a replay.
- The top-k products at forced loads (1-33 rows an expert: each height of
  the products' inner loop and its edges, experts of several chunks), at
  Moonlight's and Switch top-2's widths: the output, repeats, a replay and
  the ``moe_chunks`` counter.
- MLA at 16 heads, nope 128, rope 64, v 128, 40 prefix positions with
  pads, 1 / 31 / 100 beams of one or two queries, positions 0-3: the
  output and the written cache rows within ``MLA_TOL``.
- The f32 GEMM (RMSNorm + product, or residual) at every (N, K) of the
  stack at 1-128 rows against the plain product, on the small-row kernel.
- A stack at the published widths, cut to 1 dense + 4 expert layers: the
  program's selection scores (sigmoid + bias) over a query's tokens and
  three beam steps against ``gdrbench/reference/moonlight.py``, which the
  reference's ``ROUTE_TIE_GAP`` must exceed tenfold.
- A small decoder-only model's ``Evaluator.retrieve``: replayed (3 pieces,
  no eager decode) equal to eager bit for bit, with the same launches:
  ``mla_attention`` layers × steps, ``topk_expert_sublayer`` expert layers
  × (1 + steps).

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_moonlight.py
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gdr_tpu_torch import kernels
from gdr_tpu_torch.config import EvalConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.kernels import decode, experts, mla
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.utils import timing
from gdrbench.reference import model as M
from gdrbench.reference import moonlight as ref_ds
from gdrbench.weights_moonlight import draw_into
from chip_smoke import forced_inputs, forced_rows

LOGIT_TOL = 2e-5          # router logits ~N(0, 0.8): f32 sums of 2,048 terms
OUT_TOL = 2e-5            # outputs ~1: f32 sums of 1,408-3,072 terms
MLA_TOL = 2e-5            # attention outputs of ~1 over <= 44 keys of 320
GRAPH_KEYS = {"graph_captures", "graph_replays", "eager_decodes"}
SMALL = dict(backbone="deepseek_v3", vocab_size=512, d_model=64, num_layers=3,
             num_heads=2, d_ff=96, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, num_experts=8, moe_d_ff=32,
             num_experts_per_tok=3, num_shared_experts=1, first_k_dense=1,
             routed_scaling_factor=2.446, kary=4, max_output_length=5,
             adaptor_layer_num=1, adaptor_num_heads=2, encoder_d_model=64)
MOONLIGHT = ModelConfig().scaled("moonlight-16b-a3b")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the expert and MLA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same(a, b) -> None:
    if isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f))
    elif a is None:
        assert b is None
    else:
        assert torch.equal(a, b)


def _experts(e, d, f, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return (rnd(e, d).mul_(0.02), rnd(e).mul_(0.01),
            rnd(e, 2 * f, d).mul_(0.02), rnd(e, d, f).mul_(0.02))


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(64, 2048, 1408, 6), (128, 768, 3072, 1),
                                    (128, 768, 3072, 2)],
                         ids=["moonlight", "switch-top1", "switch-top2"])
@pytest.mark.parametrize("rows", [1, 31, 40, 100, 1280])
def test_topk_kernel_matches_plain(dev, widths, rows):
    e, d, f, k = widths
    router, bias, wi, wo = _experts(e, d, f, 3)
    g = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.randn(rows, d, generator=g, device="cuda")
    base = x + 0.1 * torch.randn(rows, d, generator=g, device="cuda")
    scale = 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")
    route = torch.empty((rows, k), dtype=torch.int32, device="cuda")
    z = torch.empty((rows, e), dtype=torch.float32, device="cuda")
    kernels.reset_launch_counts()
    out = experts.topk_expert_sublayer(x, base, scale, router, bias, wi, wo,
                                       k=k, scale=2.446, eps=1e-5,
                                       route=route, logits=z)
    card = kernels.launch_counts(experts=True)
    plain_z = experts._mm(experts._rms(x, scale, 1e-5), router)
    assert float((z - plain_z).abs().max()) < LOGIT_TOL
    # the plain version chooses from the card's logits: a near tie may
    # go either way between two f32 sums
    sel, _ = experts.topk_select(z, bias, k, 2.446)
    assert torch.equal(route.long(), sel)
    plain_route = torch.empty_like(route)
    with torch.no_grad():
        ref = experts.topk_expert_sublayer_plain(
            x, base, scale, router, _forcing(bias, z, sel), wi, wo, k=k,
            scale=2.446, eps=1e-5, route=plain_route)
    assert torch.equal(plain_route, route)
    assert float((out - ref).abs().max()) < OUT_TOL
    assert card["moe_calls"] == 1 and card["moe_rows"] == rows
    assert card["moe_assignments"] == rows * k
    assert card["moe_experts_hit"] == int(torch.unique(sel).numel())
    again = experts.topk_expert_sublayer(x, base, scale, router, bias, wi, wo,
                                         k=k, scale=2.446, eps=1e-5)
    assert torch.equal(again, out)


def _forcing(bias, z, sel):
    """A bias under which the plain version, from its own logits, chooses
    ``sel`` (the card's choice) and weighs it as the card does: the
    chosen experts lifted clear of the others.  Selection only: the
    weights are the sigmoids, which the bias does not enter."""
    out = bias.clone().expand(z.shape[0], -1).clone()
    out.scatter_add_(1, sel, torch.full(sel.shape, 10.0, device=z.device))
    return out


FORCED_LOADS = [1, 3, 4, 5, 8, 9, 16, 17, 33]


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(64, 2048, 1408, 6), (128, 768, 3072, 2)],
                         ids=["moonlight", "switch-top2"])
def test_topk_products_at_forced_loads(dev, widths):
    """Experts 0-8 given 1, 3, 4, 5, 8, 9, 16, 17 and 33 rows (each height
    of the products and its edges, experts of 2 and 3 chunks), the other
    slots on further experts, 1-2 rows each (``chip_smoke.forced_rows``):
    the output within ``OUT_TOL`` of the plain version held to the same
    experts, the same bits again and from a graph replay, and
    ``moe_chunks`` = Σ⌈load / 16⌉."""
    e, d, f, k = widths
    _, bias, wi, wo = _experts(e, d, f, 7)
    rows = forced_rows(FORCED_LOADS, k, e)
    g = torch.Generator(device="cuda").manual_seed(8)
    x, router = forced_inputs(rows, d, e, g, "cuda")
    base = x + 0.1 * torch.randn(x.shape, generator=g, device="cuda")
    scale = 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")
    route = torch.empty((len(rows), k), dtype=torch.int32, device="cuda")
    kw = dict(k=k, scale=2.446, eps=1e-5)
    kernels.reset_launch_counts()
    out = experts.topk_expert_sublayer(x, base, scale, router, bias, wi, wo,
                                       route=route, **kw)
    card = kernels.launch_counts(experts=True)
    assert route.tolist() == rows
    load = torch.bincount(route.long().flatten(), minlength=e)
    assert load[:len(FORCED_LOADS)].tolist() == FORCED_LOADS
    assert card["moe_chunks"] == int(((load + 15) // 16).sum())
    assert card["moe_assignments"] == len(rows) * k
    with torch.no_grad():
        ref = experts.topk_expert_sublayer_plain(
            x, base, scale, router, _forcing(bias, x, route.long()), wi,
            wo, **kw)
    assert float((out - ref).abs().max()) < OUT_TOL
    again = experts.topk_expert_sublayer(x, base, scale, router, bias, wi, wo,
                                         **kw)
    assert torch.equal(again, out)
    graph = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        graph.capture_begin()
        got = experts.topk_expert_sublayer(x, base, scale, router, bias, wi,
                                           wo, **kw)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, out)


@pytest.mark.cuda
def test_topk_kernel_replays_in_a_graph(dev):
    e, d, f, k = 64, 2048, 1408, 6
    router, bias, wi, wo = _experts(e, d, f, 5)
    x = torch.randn(100, d, device="cuda")
    base = x.clone()
    scale = torch.ones(d, device="cuda")
    kw = dict(k=k, scale=2.446, eps=1e-5)
    want = experts.topk_expert_sublayer(x, base, scale, router, bias, wi, wo,
                                        **kw)
    graph = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        graph.capture_begin()
        got = experts.topk_expert_sublayer(x, base, scale, router, bias, wi,
                                           wo, **kw)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(s)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _mla_inputs(b, w, s, lmax, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    r, h = b * w, 16
    q, kva, kvb = rnd(r, h * 192), rnd(r, 576), rnd(r, h * 256)
    pk, pv = rnd(b, h, s, 192), rnd(b, h, s, 128)
    lens = torch.tensor([s - 3 * i for i in range(b)], dtype=torch.int32,
                        device="cuda")
    bias = torch.where(torch.arange(s, device="cuda")[None] < lens[:, None],
                       0.0, -1e9).float()
    ck, cv = rnd(lmax, r, h, 192), rnd(lmax, r, h, 128)
    return q, kva, kvb, pk, pv, bias, lens, ck, cv


@pytest.mark.cuda
@pytest.mark.parametrize("b, w", [(1, 1), (1, 31), (1, 100), (2, 100)])
@pytest.mark.parametrize("pos", [0, 1, 3])
def test_mla_kernel_matches_plain(dev, b, w, pos):
    args = _mla_inputs(b, w, 40, 4, 7 * w + pos)
    inv = mla.rope_inv_freq(64, 50000.0, "cuda")
    ck_p, cv_p = args[7].clone(), args[8].clone()
    kernels.reset_launch_counts()
    out = mla.mla_attention(*args, pos, inv, w, scale=192 ** -0.5)
    assert kernels.launch_counts()["mla_attention"] == 1
    ref = mla.mla_attention_plain(*args[:7], ck_p, cv_p, pos, inv, w,
                                  scale=192 ** -0.5)
    assert float((out - ref).abs().max()) < MLA_TOL
    assert float((args[7] - ck_p).abs().max()) < MLA_TOL
    assert torch.equal(args[8], cv_p)
    again = mla.mla_attention(*args, pos, inv, w, scale=192 ** -0.5)
    assert torch.equal(again, out)


SHAPES = [(3072, 2048), (576, 2048), (2048, 2048), (5632, 2048),
          (22528, 2048), (4096, 512), (2048, 2816), (2048, 11264)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, k", SHAPES)
@pytest.mark.parametrize("m", [1, 31, 40, 100, 128])
def test_f32_gemm_at_the_stacks_shapes(dev, n, k, m):
    g = torch.Generator(device="cuda").manual_seed(n + k + m)
    a = torch.randn(m, k, generator=g, device="cuda")
    w = torch.randn(n, k, generator=g, device="cuda").mul_(k ** -0.5)
    plan = decode.gemm_plan(m, n, k, "cuda", torch.float32)
    assert plan.kernel == decode.KERNEL_ROWS
    if k in (2048, 512):                   # the norm-fused projections
        scale = torch.rand(k, generator=g, device="cuda") + 0.5
        got = decode.gemm(a, w, "round", scale=scale, eps=1e-5)
        want = decode.gemm_plain(a, w, "round", scale=scale, eps=1e-5)
    else:                                  # the down projections
        resid = torch.randn(m, n, generator=g, device="cuda")
        got = decode.gemm(a, w, "residual", resid=resid)
        want = decode.gemm_plain(a, w, "residual", resid=resid)
    assert float((got - want).abs().max()) < 2e-5 * (1 + k / 2048)


def _moonlight_cut(dev, layers: int):
    cfg = ModelConfig(**{**MOONLIGHT.__dict__, "num_layers": layers,
                         "kary": 4, "max_output_length": 5})
    with dev:
        model = GenerativeRetriever(cfg)
    return model.eval(), draw_into(model, 2**33 + 5)


@pytest.mark.cuda
def test_selection_scores_against_the_reference_at_the_published_widths(dev):
    """1 dense + 4 expert layers at Moonlight's widths: the largest
    |program − reference| selection score of any expert layer, over a
    40-token query's prefill and three beam steps of 31 rows, is under a
    tenth of the reference's ``ROUTE_TIE_GAP``."""
    model, w = _moonlight_cut(dev, 5)
    cfg = {**MOONLIGHT.__dict__, "num_layers": 5}
    moe = [b.ff for b in model.stack.blocks[1:]]
    for ff in moe:
        ff.record = []
    g = torch.Generator(device="cuda").manual_seed(9)
    ids = torch.randint(2, cfg["vocab_size"], (1, 40), generator=g,
                        device="cuda")
    mask = torch.ones_like(ids)
    beams, steps = 31, 3
    toks = torch.zeros((beams, steps), dtype=torch.long, device="cuda")
    for p in range(1, steps):
        toks[:, p] = (p - 1) * 4 + 2 + torch.randint(
            0, 4, (beams,), generator=g, device="cuda")
    M.f32_matmul_only()
    with torch.no_grad():
        enc, prefix = model.prefill(ids, mask)
        cache = model.init_cache(enc, steps, beams, prefix)
        cache["cross_ucand"] = model.decode_tables(steps)
        for pos in range(steps):
            _, cache = model.decode_step_candidates(
                toks[:, pos].int(), cache, mask, pos, beams)
        x = torch.cat([w["shared.weight"][ids[0]][None].expand(beams, -1, -1),
                       w["decode_embed.weight"][toks]], dim=1)
        scores: list = []
        ref_ds.stack(w, cfg, x, None, None, ref_ds.Routing(), scores)
    errs = []
    for j, ff in enumerate(moe):
        bias = ff.score_bias.detach()
        ref = scores[j].view(beams, 40 + steps, -1)
        prog = torch.sigmoid(ff.record[0][1]) + bias          # the prefill
        errs.append(float((prog - ref[0, :40]).abs().max()))
        for pos in range(steps):
            prog = torch.sigmoid(ff.record[1 + pos][1]) + bias
            errs.append(float((prog - ref[:, 40 + pos]).abs().max()))
        ff.record = None
    print(json.dumps({"selection_errs": errs}))
    assert max(errs) * 10 <= ref_ds.ROUTE_TIE_GAP


def _cid_map():
    cids = [f"{a}-{b}-{c}" for a in range(4) for b in range(3)
            for c in range(2)]
    return {c: [3 * i, 3 * i + 1, 3 * i + 2] for i, c in enumerate(cids)}


def _evaluator(model):
    trie = build_trie(_cid_map(), SMALL["kary"])
    rng = np.random.default_rng(2)
    store = rng.normal(size=(72, SMALL["encoder_d_model"]))
    store = (store / np.linalg.norm(store, axis=1, keepdims=True)
             ).astype(np.float32)
    return Evaluator(model, trie, store,
                     EvalConfig(num_beams=12, num_return_sequences=20,
                                max_output_length=5), packed=True)


@pytest.mark.cuda
def test_replayed_moonlight_retrieve_is_the_eager_retrieve(dev):
    """At the kernels' head widths (nope 128, rope 64, v 128) and d 256."""
    small = dict(SMALL, d_model=256, qk_nope_head_dim=128,
                 qk_rope_head_dim=64, v_head_dim=128, encoder_d_model=64)
    model = init_weights(GenerativeRetriever(ModelConfig(**small)),
                         torch.Generator().manual_seed(0)).to(dev).eval()
    ev = _evaluator(model)
    rng = np.random.default_rng(0)
    for seed in (1, 2, 3, 4):
        ids = rng.integers(2, 512, size=(1, 10)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[0, 7:] = 0
        kernels.reset_launch_counts()
        want = _evaluator(model).retrieve(ids, mask)
        eager = {**timing.counts(), **kernels.launch_counts(experts=True)}
        kernels.reset_launch_counts()
        got = ev.retrieve(ids, mask)
        replayed = {**timing.counts(), **kernels.launch_counts(experts=True)}
        _same(want, got)
        assert replayed["graph_replays"] == (seed > 1) * 3
        assert replayed["eager_decodes"] == (seed == 1)
        assert {k: v for k, v in replayed.items() if k not in GRAPH_KEYS} \
            == {k: v for k, v in eager.items() if k not in GRAPH_KEYS}
        assert replayed["mla_attention"] == 3 * 4
        assert replayed["topk_expert_sublayer"] == 2 * (1 + 4)
