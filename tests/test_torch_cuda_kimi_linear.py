"""Kimi Linear's kernels on the card against their plain versions: the KDA
prefill and decode step (``csrc/kda.cu``), the chip's-share top-k expert
layer at d 2,304, NoPE latent attention, and a small Kimi Linear
retrieve replayed as CUDA graphs against the same retrieve run eagerly.
Every test needs a CUDA device (``cuda`` marker; they skip without one).

- KDA at the published head shape (32 heads of 128, 4 taps): the decode
  step at 1, 31 and 100 rows, reading the prefix state (rows of a query
  share it), a beam step's source rows, or the row's own, within
  ``KDA_TOL`` of the plain version in its output, its new state and its
  window; a second call and a graph replay give the same bits; the kernel
  counts each distinct source row once (``kda_source_rows``).  The
  prefill of one and of two queries (40 positions, pads) likewise, its
  real tokens counted (``kda_prefill_tokens``).
- The expert share at Kimi Linear's widths (256 experts routed over, 32
  held at offset 0 and at 224, d 2,304, d_ff 1,024, top-8) at 1, 31 and
  100 rows: the routing over all 256, the counters (``moe_held``) and the
  output within ``OUT_TOL`` of the plain version.
- MLA without rotation at 32 heads against the plain version.
- A small Kimi Linear model's ``Evaluator.retrieve``: replayed equal to
  eager bit for bit with the same launches: ``kda_prefill`` a KDA layer,
  ``kda_decode`` KDA layers × steps; the card's source rows those of the
  CPU's plain versions.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kimi_linear.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gdr_tpu_torch import kernels
from gdr_tpu_torch.config import EvalConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.kernels import experts, kda, mla
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.utils import timing

KDA_TOL = 3e-5        # outputs ~1, states ~0.1: f32 sums of 128-384 terms
OUT_TOL = 2e-5        # expert outputs ~1: f32 sums of 1,024-2,304 terms
LOGIT_TOL = 2e-5
MLA_TOL = 2e-5
GRAPH_KEYS = {"graph_captures", "graph_replays", "eager_decodes"}
H, K, T = 32, 128, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the KDA, expert and MLA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(seed: int, heads: int = H):
    """A KDA layer's kernel weights: w_fb, w_gb, conv_w, a_log, dt_bias,
    norm_w, at the scales of the benchmark's draw."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    inner = heads * K
    return (rnd(inner, K).mul_(0.02), rnd(inner, K).mul_(0.02),
            rnd(3 * inner, T).mul_(0.5), rnd(heads).mul_(0.5).add_(1.0),
            rnd(inner).mul_(0.5).sub_(4.0), 1.0 + 0.1 * rnd(K))


def _rows(rows: int, seed: int, heads: int = H):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(rows, 3 * heads * K, generator=g, device="cuda"),
            torch.randn(rows, 2 * K + heads, generator=g, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 100])
@pytest.mark.parametrize("source", ["prefix", "beams", "own"])
def test_kda_decode_matches_plain(dev, rows, source):
    w = _layer(1)
    qkv, fgb = _rows(rows, rows)
    g = torch.Generator(device="cuda").manual_seed(7)
    n_in = {"prefix": 1, "beams": max(rows // 3, 1), "own": rows}[source]
    s_in = 0.1 * torch.randn(n_in, H, K, K, generator=g, device="cuda")
    c_in = torch.randn(n_in, T - 1, 3 * H * K, generator=g, device="cuda")
    src = (torch.randint(0, n_in, (rows,), generator=g, device="cuda",
                         dtype=torch.int32) if source == "beams" else None)
    outs = []
    kernels.reset_launch_counts()
    for fn in (kda.kda_decode, kda.kda_decode_plain):
        s_out = torch.full((rows, H, K, K), float("nan"), device="cuda")
        c_out = torch.full((rows, T - 1, 3 * H * K), float("nan"),
                           device="cuda")
        o = fn(qkv, fgb, *w, s_in, c_in, src, s_out, c_out, heads=H,
               eps=1e-5)
        outs.append((o, s_out, c_out))
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) < KDA_TOL
    assert torch.equal(outs[0][2], outs[1][2])          # the window: copies
    # the kernel counts each source row once
    assert kernels.launch_counts(experts=True)["kda_source_rows"] == (
        n_in if src is None else int(src.unique().numel()))
    s_out = torch.empty_like(outs[0][1])
    c_out = torch.empty_like(outs[0][2])
    again = kda.kda_decode(qkv, fgb, *w, s_in, c_in, src, s_out, c_out,
                           heads=H, eps=1e-5)
    assert torch.equal(again, outs[0][0]) and torch.equal(s_out, outs[0][1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = kda.kda_decode(qkv, fgb, *w, s_in, c_in, src, s_out,
                                  c_out, heads=H, eps=1e-5)
    s_out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, outs[0][0]) and torch.equal(s_out,
                                                             outs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [[40], [6, 23]])
def test_kda_prefill_matches_plain(dev, lens):
    w = _layer(2)
    b, s = len(lens), 40
    qkv, fgb = _rows(b * s, 3)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kernels.reset_launch_counts()
    got = kda.kda_prefill(qkv, fgb, *w, n, batch=b, heads=H, eps=1e-5)
    assert kernels.launch_counts(experts=True)["kda_prefill_tokens"] \
        == sum(lens)
    want = kda.kda_prefill_plain(qkv, fgb, *w, n, batch=b, heads=H, eps=1e-5)
    for a, c in zip(got, want):
        assert float((a - c).abs().max()) < KDA_TOL
    pads = torch.arange(s, device="cuda")[None] >= n[:, None]
    assert not got[0].view(b, s, -1)[pads].any()


def _share_inputs(rows: int, seed: int, n_exp=256, held=32, d=2304, f=1024):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = rnd(rows, d)
    return (x, x + 0.1 * rnd(rows, d), 1.0 + 0.1 * rnd(d),
            rnd(n_exp, d).mul_(0.02), rnd(n_exp).mul_(0.01),
            rnd(held, 2 * f, d).mul_(0.02), rnd(held, d, f).mul_(0.02))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 100])
@pytest.mark.parametrize("offset", [0, 224])
def test_expert_share_matches_plain_at_d_2304(dev, rows, offset):
    x, base, scale, router, bias, wi, wo = _share_inputs(rows, rows + offset)
    route = torch.empty((rows, 8), dtype=torch.int32, device="cuda")
    z = torch.empty((rows, 256), device="cuda")
    kernels.reset_launch_counts()
    out = experts.topk_expert_sublayer(x, base, scale, router, bias, wi, wo,
                                       k=8, scale=2.446, eps=1e-5,
                                       route=route, logits=z, offset=offset)
    card = kernels.launch_counts(experts=True)
    plain_z = experts._mm(experts._rms(x, scale, 1e-5), router)
    assert float((z - plain_z).abs().max()) < LOGIT_TOL
    sel, _ = experts.topk_select(z, bias, 8, 2.446)
    assert torch.equal(route.long(), sel)
    ref = torch.empty_like(out)
    for r in range(rows):       # the plain version given the card's choice
        b = bias.clone()
        b[sel[r]] += 10.0
        ref[r] = experts.topk_expert_sublayer_plain(
            x[r:r + 1], base[r:r + 1], scale, router, b, wi, wo, k=8,
            scale=2.446, eps=1e-5, offset=offset)[0]
    assert float((out - ref).abs().max()) < OUT_TOL
    mine = ((sel >= offset) & (sel < offset + 32))
    assert card["moe_assignments"] == rows * 8
    assert card["moe_held"] == int(mine.sum())
    assert card["moe_experts_hit"] == int(torch.unique(sel[mine]).numel())
    if not mine.any():
        assert torch.equal(out, base)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 31, 100])
def test_mla_without_rotation_matches_plain(dev, w):
    g = torch.Generator(device="cuda").manual_seed(w)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    h, s, lmax, pos = 32, 40, 4, 2
    q, kva, kvb = rnd(w, h * 192), rnd(w, 576), rnd(w, h * 256)
    pk, pv = rnd(1, h, s, 192), rnd(1, h, s, 128)
    bias = torch.zeros(1, s, device="cuda")
    bias[0, 30:] = mla.NEG_INF
    lens = torch.tensor([30], dtype=torch.int32, device="cuda")
    caches = [(0.1 * torch.ones(lmax, w, h, 192, device="cuda"),
               0.1 * torch.ones(lmax, w, h, 128, device="cuda"))
              for _ in range(2)]
    inv = mla.rope_inv_freq(64, 10000.0, "cuda")
    got = mla.mla_attention(q, kva, kvb, pk, pv, bias, lens, *caches[0], pos,
                            inv, w, scale=192 ** -0.5, rotate=False)
    want = mla.mla_attention_plain(q, kva, kvb, pk, pv, bias, lens,
                                   *caches[1], pos, inv, w,
                                   scale=192 ** -0.5, rotate=False)
    assert float((got - want).abs().max()) < MLA_TOL
    assert torch.equal(caches[0][0], caches[1][0])
    assert torch.equal(caches[0][0][pos, :, 0, 128:], kva[:, 512:])


SMALL = dict(backbone="kimi_linear", vocab_size=512, d_model=256,
             num_layers=4, num_heads=2, d_ff=96, kv_lora_rank=32,
             qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
             mla_use_nope=True, num_experts=16, experts_held=8,
             expert_offset=8, moe_d_ff=32, num_experts_per_tok=4,
             num_shared_experts=1, first_k_dense=1,
             routed_scaling_factor=2.446, kda_layers=(1, 2, 3),
             full_attn_layers=(4,), kda_num_heads=8, kda_head_dim=128,
             kary=4, max_output_length=5, adaptor_layer_num=1,
             adaptor_num_heads=2, encoder_d_model=64)


def _evaluator(model):
    cids = [f"{a}-{b}-{c}" for a in range(4) for b in range(3)
            for c in range(2)]
    trie = build_trie({c: [3 * i, 3 * i + 1, 3 * i + 2]
                       for i, c in enumerate(cids)}, SMALL["kary"])
    rng = np.random.default_rng(2)
    store = rng.normal(size=(72, SMALL["encoder_d_model"]))
    store = (store / np.linalg.norm(store, axis=1, keepdims=True)
             ).astype(np.float32)
    return Evaluator(model, trie, store,
                     EvalConfig(num_beams=12, num_return_sequences=20,
                                max_output_length=5), packed=True)


def _same(a, b) -> None:
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b, strict=True):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for name in a.__dataclass_fields__:
            _same(getattr(a, name), getattr(b, name))
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_replayed_kimi_linear_retrieve_is_the_eager_retrieve(dev):
    model = init_weights(GenerativeRetriever(ModelConfig(**SMALL)),
                         torch.Generator().manual_seed(0)).to(dev).eval()
    cpu = init_weights(GenerativeRetriever(ModelConfig(**SMALL)),
                       torch.Generator().manual_seed(0)).eval()
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
        assert {k: v for k, v in replayed.items() if k not in GRAPH_KEYS} \
            == {k: v for k, v in eager.items() if k not in GRAPH_KEYS}
        assert replayed["kda_prefill"] == 3
        assert replayed["kda_decode"] == 3 * 4
        assert replayed["mla_attention"] == 4
        assert replayed["kda_state_rows"] == 3 * (1 + 5 + 12 + 12)
        assert replayed["kda_prefill_tokens"] == 3 * 7
        assert 3 * 4 <= replayed["kda_source_rows"] <= 3 * (1 + 1 + 5 + 12)
        if seed == 1:   # the card against the CPU's plain versions
            kernels.reset_launch_counts()
            res, rr = _evaluator(cpu).retrieve(ids, mask)
            assert kernels.launch_counts(experts=True)["kda_source_rows"] \
                == replayed["kda_source_rows"]
            assert torch.equal(res.sequences, want[0].sequences.cpu())
            assert float((res.scores - want[0].scores.cpu()).abs().max()
                         ) < 1e-4
