"""The routed-expert kernels (``csrc/experts.cu``) on the card against their
plain version, and a Switch retrieve replayed as CUDA graphs against the
same retrieve run eagerly.  Every test needs a CUDA device (``cuda``
marker; they skip without one).

- A dense model's retrieve neither builds nor loads the expert library
  (first, before any test of this file loads it).
- At Switch-Base-128's widths (128 experts, d 768, d_ff 3,072, the router
  at N(0, 1), the experts at N(0, 0.02)) and 1, 40, 100, 1,280 and 3,200
  rows (a decode step of one and of 100 beams, a query's and 32 queries'
  encoder tokens, 32 queries' beams): the same experts, kept rows and
  counters, router logits within ``LOGIT_TOL`` and the output within
  ``OUT_TOL`` of the plain version's products on cuBLAS with TF32 off.
  Both sum f32 products in different orders over 768 (router) and 3,072
  (wo) terms of logits of ~28 and outputs of ~1, so they differ by a few
  ulps of those sums, not by TF32's 1e-3.
- Capacity: tokens dropped on the card as in the plain version.
- The Switch encoder and three cached decode steps at the cell's widths
  against ``gdrbench/reference/switch.py``: the largest |program −
  reference| router logit of any sparse layer, which the cell's
  ``ROUTE_TIE_GAP`` must exceed tenfold.
- A small Switch model's ``Evaluator.retrieve``: replayed (3 pieces, no
  eager decode, 2 host syncs) equal to eager bit for bit, with the same
  launches, 1 + 4 expert calls a retrieve (one sparse layer a stack, four
  steps).

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_experts.py
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gdr_tpu_torch import kernels
from gdr_tpu_torch.config import EvalConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.kernels import build, experts
from gdr_tpu_torch.models import t5
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.utils import timing
from gdrbench.drivers import serve_switch
from gdrbench.reference import model as M
from gdrbench.reference import switch as ref_switch
from gdrbench.weights_switch import load_into, make_weights

ROOT = Path(__file__).resolve().parents[1]
E, D, DFF = 128, 768, 3072
LOGIT_TOL = 1e-4          # router logits ~N(0, 768): f32 sums of 768 terms
OUT_TOL = 2e-5            # outputs ~1: f32 sums of 3,072 terms
GRAPH_KEYS = {"graph_captures", "graph_replays", "eager_decodes"}
SMALL = dict(kary=4, max_output_length=5, d_model=64, d_kv=16, d_ff=128,
             num_layers=2, num_decoder_layers=2, num_heads=4, vocab_size=512,
             encoder_d_model=64, adaptor_layer_num=1, adaptor_num_heads=2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the expert kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same(a, b) -> None:
    """Two results (tensors, dataclasses of tensors or None, tuples of
    them) are equal bit for bit."""
    if isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f))
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _stats():
    return {k: v for k, v in kernels.launch_counts(experts=True).items()
            if k.startswith("moe_")}


def _cid_map():
    """24 clusters of depth 3 (4 · 3 · 2), three docs each."""
    cids = [f"{a}-{b}-{c}" for a in range(4) for b in range(3)
            for c in range(2)]
    return {c: [3 * i, 3 * i + 1, 3 * i + 2] for i, c in enumerate(cids)}


def _evaluator(model, dev):
    trie = build_trie(_cid_map(), SMALL["kary"])
    rng = np.random.default_rng(2)
    store = rng.normal(size=(72, SMALL["encoder_d_model"]))
    store = (store / np.linalg.norm(store, axis=1, keepdims=True)
             ).astype(np.float32)
    return Evaluator(model, trie, store,
                     EvalConfig(num_beams=12, num_return_sequences=20,
                                max_output_length=5), packed=True)


def _queries(batch, seed, seq=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, SMALL["vocab_size"], size=(batch, seq))
    mask = np.ones_like(ids)
    mask[-1, seq - 3:] = 0
    return ids.astype(np.int32), mask.astype(np.int32)


@pytest.mark.cuda
def test_a_dense_retrieve_builds_and_loads_no_expert_library(dev):
    model = init_weights(GenerativeRetriever(ModelConfig(**SMALL)),
                         torch.Generator().manual_seed(0)).to(dev).eval()
    ev = _evaluator(model, dev)
    for seed in (1, 2, 3):
        ev.retrieve(*_queries(2, seed))
    assert "experts" not in build._libs and not experts._STATS
    assert "experts" in build.sources()


def _weights(seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    router = torch.randn(E, D, generator=g, device="cuda")
    wi = torch.randn(E, DFF, D, generator=g, device="cuda").mul_(0.02)
    wo = torch.randn(E, D, DFF, generator=g, device="cuda").mul_(0.02)
    scale = 1 + 0.1 * torch.randn(D, generator=g, device="cuda")
    return scale, router, wi, wo


@pytest.mark.cuda
@pytest.mark.parametrize("rows, seq_len", [(1, 1), (40, 40), (100, 1),
                                           (1280, 40), (3200, 1)])
def test_kernel_matches_plain_at_switch_base_widths(dev, rows, seq_len):
    scale, router, wi, wo = _weights(rows)
    g = torch.Generator(device="cuda").manual_seed(rows + 1)
    x = torch.randn(rows, D, generator=g, device="cuda")
    counts = (torch.randint(0, 3, (rows // seq_len, E), generator=g,
                            device="cuda", dtype=torch.int32)
              if seq_len == 1 else None)
    z_k = torch.empty(rows, E, device="cuda")
    z_p = torch.empty(rows, E, device="cuda")
    c_k = None if counts is None else counts.clone()
    c_p = None if counts is None else counts.clone()
    kernels.reset_launch_counts()
    got = experts.expert_sublayer(x, scale, router, wi, wo, capacity=64,
                                  seq_len=seq_len, counts=c_k, logits=z_k)
    torch.cuda.synchronize()
    on_card = _stats()
    kernels.reset_launch_counts()
    want = experts.expert_sublayer_plain(x, scale, router, wi, wo,
                                         capacity=64, seq_len=seq_len,
                                         counts=c_p, logits=z_p)
    assert _stats() == on_card
    assert on_card["moe_rows"] == rows and on_card["moe_dropped"] == 0
    logit_err = float((z_k - z_p).abs().max())
    out_err = float((got - want).abs().max())
    print(json.dumps({"rows": rows, "logit_err": logit_err,
                      "out_err": out_err, **on_card}))
    assert logit_err < LOGIT_TOL and out_err < OUT_TOL
    assert torch.equal(z_k.argmax(1), z_p.argmax(1))
    if counts is not None:
        assert torch.equal(c_k, c_p)
    # the same bits every call
    again = experts.expert_sublayer(x, scale, router, wi, wo, capacity=64,
                                    seq_len=seq_len, counts=counts)
    assert torch.equal(again, got)
    assert kernels.launch_counts()["expert_sublayer"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1, 2, 5])
def test_kernel_drops_tokens_as_plain(dev, capacity):
    g = torch.Generator(device="cuda").manual_seed(capacity)
    d, dff, n_exp = 64, 128, 4
    x = torch.randn(3 * 16, d, generator=g, device="cuda")
    router = torch.randn(n_exp, d, generator=g, device="cuda")
    wi = 0.1 * torch.randn(n_exp, dff, d, generator=g, device="cuda")
    wo = 0.1 * torch.randn(n_exp, d, dff, generator=g, device="cuda")
    scale = torch.ones(d, device="cuda")
    kernels.reset_launch_counts()
    got = experts.expert_sublayer(x, scale, router, wi, wo,
                                  capacity=capacity, seq_len=16)
    on_card = _stats()
    kernels.reset_launch_counts()
    want = experts.expert_sublayer_plain(x, scale, router, wi, wo,
                                         capacity=capacity, seq_len=16)
    assert _stats() == on_card and on_card["moe_dropped"] > 0
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.cuda
def test_bf16_is_refused_on_the_card(dev):
    x = torch.zeros(4, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="float32 models only"):
        experts.expert_sublayer(
            x, torch.ones(64, dtype=torch.bfloat16, device=dev),
            *(torch.zeros(s, dtype=torch.bfloat16, device=dev)
              for s in ((4, 64), (4, 128, 64), (4, 64, 128))),
            capacity=2, seq_len=4)


@pytest.mark.cuda
def test_router_logits_against_the_reference_at_the_cells_widths(
        dev, monkeypatch):
    """The cell's model (seed 2**33 + 1) on one 40-token query and three
    cached decode steps of 4 beams, the router logits of every sparse
    layer against the reference's on the same weights."""
    cfg = json.loads((ROOT / "gdrbench/configs/gdr-switch-base-128-f32.json")
                     .read_text())
    m = {**cfg["model"], "dropout_rate": 0.0}
    w = make_weights(m, 2**33 + 1, dev)
    with torch.device("meta"):
        model = GenerativeRetriever(ModelConfig(**m))
    load_into(model, w)
    model.eval()
    prog, ref = [], []
    real_sub, real_ffn = t5.expert_sublayer, ref_switch.routed_ffn

    def sub(x, *a, **k):
        z = torch.empty(x.shape[0], a[1].shape[0], device=x.device)
        out = real_sub(x, *a, logits=z, **k)
        prog.append(z)
        return out

    def ffn(w_, p, cfg_, h, gaps):
        ref.append(M.mm(h, M.w32(w_, p + "router").t(), held=False))
        return real_ffn(w_, p, cfg_, h, gaps)

    monkeypatch.setattr(t5, "expert_sublayer", sub)
    monkeypatch.setattr(ref_switch, "routed_ffn", ffn)
    g = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(2, m["vocab_size"], (1, 40), generator=g, device=dev)
    mask = torch.ones_like(ids)
    mask[0, 30:] = 0
    beams, steps = 4, 3
    tokens = torch.zeros((beams, steps), dtype=torch.long, device=dev)
    for p in range(1, steps):
        tokens[:, p] = (p - 1) * m["kary"] + 2 + torch.randint(
            0, m["kary"], (beams,), generator=g, device=dev)
    errs = []
    with torch.no_grad():
        enc = model.encode(ids, mask)
        ref_enc = ref_switch.encode(w, m, ids, mask)
        errs += [float((a - b.reshape(a.shape)).abs().max())
                 for a, b in zip(prog, ref)]
        cache = model.init_cache(enc, steps, beams)
        cache["cross_ucand"] = model.decode_tables(steps)
        for pos in range(steps):
            prog.clear()
            ref.clear()
            model.decode_step_candidates(tokens[:, pos].int(), cache, mask,
                                         pos, beams)
            ref_switch.decode(w, m, tokens[:, :pos + 1], ref_enc, mask)
            errs += [float((a - b[:, pos]).abs().max())
                     for a, b in zip(prog, ref)]
    print(json.dumps({"router_logit_errs": errs}))
    assert len(errs) == 6 + 3 * steps
    assert max(errs) * 10 <= serve_switch.ROUTE_TIE_GAP


@pytest.mark.cuda
def test_replayed_switch_retrieve_is_the_eager_retrieve(dev):
    model = init_weights(
        GenerativeRetriever(ModelConfig(**SMALL, num_experts=8,
                                        expert_capacity=2)),
        torch.Generator().manual_seed(0)).to(dev).eval()
    ev = _evaluator(model, dev)
    for seed in (1, 2, 3, 4):
        ids, mask = _queries(1, seed)
        kernels.reset_launch_counts()
        want = _evaluator(model, dev).retrieve(ids, mask)
        eager = {**timing.counts(), **kernels.launch_counts(experts=True)}
        kernels.reset_launch_counts()
        got = ev.retrieve(ids, mask)
        replayed = {**timing.counts(),
                    **kernels.launch_counts(experts=True)}
        _same(want, got)
        assert replayed["graph_replays"] == (seed > 1) * 3
        assert replayed["eager_decodes"] == (seed == 1)
        assert replayed["host_syncs"] == eager["host_syncs"] == 2
        assert {k: v for k, v in replayed.items() if k not in GRAPH_KEYS} \
            == {k: v for k, v in eager.items() if k not in GRAPH_KEYS}
        assert replayed["expert_sublayer"] == 1 + 1 * 4
        assert replayed["moe_calls"] == 5 and replayed["moe_dropped"] > 0
