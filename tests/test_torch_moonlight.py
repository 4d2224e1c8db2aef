"""The port's decoder-only DeepSeek-V3 generator (Moonlight-16B-A3B's block)
on the CPU (its plain versions), at a tiny shape: d 64, 2 heads, latent 32,
rope 8, 8 experts top-3, 1 shared, 1 dense + 2 expert layers.

- the port's stack, loaded from a ``transformers`` checkpoint through
  ``models/convert.py``, and the benchmark's plain reference
  (``gdrbench/reference/moonlight.py``) each match ``DeepseekV3Model``;
- the cached decode over the shared query prefix matches the reference's
  full-sequence recomputation, step by step;
- a whole ``Evaluator.retrieve`` matches the reference's beams, scores and
  top-R;
- the reference's route following takes a planted near tie and refuses a
  set outside the gap;
- the published preset's parameter count; T5 and Switch models build as
  before; training is refused;
- the routing counter ``moe_chunks`` (Σ⌈load / 16⌉, the top-k path's
  work chunks): its count, its place among the counters, and a capture.

The file imports neither JAX nor the JAX package."""

from __future__ import annotations

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

from gdr_tpu_torch import kernels
from gdr_tpu_torch.config import EvalConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.kernels import experts, mla
from gdr_tpu_torch.models import convert
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.ops import decode_graphs
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.utils import timing
from gdrbench import compare
from gdrbench.reference import model as M
from gdrbench.reference import moonlight as ref_ds
from gdrbench.reference import serve as ref_serve
from gdrbench.traffic.world import bench_cid_map, unit_store
from chip_smoke import forced_inputs, forced_rows

TOL = 1e-5      # f32 in another summation order, through three layers
TINY = dict(backbone="deepseek_v3", vocab_size=128, d_model=64, num_layers=3,
            num_heads=2, d_ff=96, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, rope_theta=50000.0,
            layer_norm_epsilon=1e-5, num_experts=8, moe_d_ff=32,
            num_experts_per_tok=3, num_shared_experts=1, first_k_dense=1,
            routed_scaling_factor=2.446, kary=4, max_output_length=5,
            adaptor_layer_num=1, adaptor_num_heads=2, encoder_d_model=16,
            dropout_rate=0.0)


def _hf_config():
    from transformers import DeepseekV3Config
    return DeepseekV3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=2,
        num_key_value_heads=2, n_shared_experts=1, n_routed_experts=8,
        num_experts_per_tok=3, n_group=1, topk_group=1,
        first_k_dense_replace=1, kv_lora_rank=32, q_lora_rank=None,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        rope_theta=50000.0, rms_norm_eps=1e-5, routed_scaling_factor=2.446,
        norm_topk_prob=True, max_position_embeddings=64,
        attn_implementation="eager")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny random ``DeepseekV3ForCausalLM`` saved as a checkpoint
    directory (Moonlight's tensor names); routers at N(0, 0.3²), score
    biases N(0, 0.1²), norms near 1."""
    from transformers import DeepseekV3ForCausalLM

    torch.manual_seed(3)
    hf = DeepseekV3ForCausalLM(_hf_config()).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.copy_(1 + 0.1 * torch.randn_like(p))
            elif "gate.weight" in name:
                p.normal_(0, 0.3)
            else:
                p.normal_(0, 0.05)
        for layer in hf.model.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.normal_(0, 0.1)
    path = tmp_path_factory.mktemp("hf_deepseek")
    hf.save_pretrained(str(path))
    return str(path), hf.model


def _model(seed: int = 0) -> GenerativeRetriever:
    torch.manual_seed(seed)
    model = GenerativeRetriever(ModelConfig(**TINY))
    return init_weights(model, torch.Generator().manual_seed(seed)).eval()


def _loaded(path: str) -> GenerativeRetriever:
    over = convert.deepseek_v3_model_overrides(path)
    model = GenerativeRetriever(ModelConfig(**{**TINY, **over}))
    init_weights(model, torch.Generator().manual_seed(5))
    return convert.load_deepseek_v3(model, convert.read_state_dict(path))


def _queries(batch: int, seq: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(2, TINY["vocab_size"], (batch, seq), generator=g)
    mask = torch.ones_like(ids)
    mask[-1, seq - 3:] = 0                       # one query with padding
    return ids * mask, mask


def _cfg(model) -> dict:
    return dataclasses.asdict(model.cfg)


# ------------------------------------------------------------ transformers

def test_stack_and_reference_match_transformers(hf_dir):
    path, hf = hf_dir
    model = _loaded(path)
    assert model.cfg.num_experts == 8 and model.cfg.first_k_dense == 1
    w, cfg = dict(model.state_dict()), _cfg(model)
    ids, mask = _queries(2, 9, 1)
    kernels.reset_launch_counts()
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got, prefix = model.prefill(ids, mask)
        ref = ref_ds.encode(w, cfg, ids, mask)
    keep = mask.bool()
    assert float((got - want)[keep].abs().max()) < TOL
    assert float((ref - want)[keep].abs().max()) < TOL
    assert prefix["cross_mla_len"].tolist() == [9, 6]
    assert tuple(prefix["cross_mla_k_2"].shape) == (2, 2, 9, 24)
    stats = kernels.launch_counts(experts=True)
    assert stats["moe_calls"] == 2 and stats["moe_assignments"] == 2 * 18 * 3


def test_config_overrides_refuse_what_is_not_ported(tmp_path, hf_dir):
    c = json.loads((__import__("pathlib").Path(hf_dir[0])
                    / "config.json").read_text())
    c["q_lora_rank"] = 16
    (tmp_path / "config.json").write_text(json.dumps(c))
    with pytest.raises(ValueError, match="not ported"):
        convert.deepseek_v3_model_overrides(str(tmp_path))


# ------------------------------------------------------- plain reference

def test_cached_decode_matches_the_full_sequence_reference():
    """Each step's candidate logits of the cached decode, three beam rows a
    query over the shared prefix, equal the reference's stack recomputed
    over the query and the beam's CID inputs."""
    model = _model()
    w, cfg = dict(model.state_dict()), _cfg(model)
    ids, mask = _queries(2, 10, 2)
    beams, steps = 3, 5
    g = torch.Generator().manual_seed(4)
    tokens = torch.zeros((2 * beams, steps), dtype=torch.long)
    for p in range(1, steps):
        tokens[:, p] = (p - 1) * TINY["kary"] + 2 + torch.randint(
            0, TINY["kary"], (2 * beams,), generator=g)
    kernels.reset_launch_counts()
    with torch.no_grad():
        enc, prefix = model.prefill(ids, mask)
        cache = model.init_cache(enc, steps, beams, prefix)
        cache["cross_ucand"] = model.decode_tables(steps)
        for pos in range(steps):
            got, cache = model.decode_step_candidates(
                tokens[:, pos].int(), cache, mask, pos, beams)
            inputs = tokens[:, :pos + 1]
            hid = ref_ds.decode(w, cfg, inputs, ids, mask)[:, pos]
            ada = M.pawa(w, cfg, inputs)[:, pos]
            want = M.candidate_logits(w, cfg, hid, ada, pos)
            assert float((got - want).abs().max()) < TOL, pos
    assert kernels.launch_counts()["mla_attention"] == 0   # plain on the CPU


def test_mla_plain_rows_write_the_cache_in_place():
    """The plain MLA step writes the row's rotated key and value at
    ``pos``; a beam row of another query never reads this query's
    prefix."""
    g = torch.Generator().manual_seed(0)
    b, w_, h, s, lmax = 2, 3, 2, 5, 4
    q = torch.randn(b * w_, h * 24, generator=g)
    kva = torch.randn(b * w_, 40, generator=g)
    kvb = torch.randn(b * w_, h * 32, generator=g)
    pk = torch.randn(b, h, s, 24, generator=g)
    pv = torch.randn(b, h, s, 16, generator=g)
    bias = torch.zeros(b, s)
    lens = torch.tensor([5, 5], dtype=torch.int32)
    ck, cv = torch.zeros(lmax, b * w_, h, 24), torch.zeros(lmax, b * w_, h, 16)
    inv = mla.rope_inv_freq(8, 50000.0)
    out = mla.mla_attention(q, kva, kvb, pk, pv, bias, lens, ck, cv, 0, inv,
                            w_, scale=24 ** -0.5)
    assert torch.equal(cv[0], kvb.view(b * w_, h, 32)[..., 16:])
    assert torch.equal(ck[0, :, 0, 16:], ck[0, :, 1, 16:])  # one k_pe
    pv2 = pv.clone()
    pv2[1] += 1.0
    out2 = mla.mla_attention(q, kva, kvb, pk, pv2, bias, lens, ck.clone(),
                             cv.clone(), 0, inv, w_, scale=24 ** -0.5)
    assert torch.equal(out[:w_], out2[:w_]) and not torch.equal(out[w_:],
                                                                 out2[w_:])


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
    kernels.reset_launch_counts()
    res, rr = ev.retrieve(ids.numpy(), mask.numpy())
    served = {"doc_ids": rr.doc_ids.numpy(), "fused": rr.scores.numpy(),
              "sequences": res.sequences.numpy(),
              "beam_scores": res.scores.numpy(), "valid": res.valid.numpy()}
    max_len = min(5, max(len(c.split("-")) for c in cid_map) + 1)
    with torch.no_grad():
        beams, ref_rr = ref_ds.retrieve(
            w, cfg, ecfg, store, ref_serve.Trie(cid_map, 4), cid_map, ids,
            mask, max_len)
    cids = {tuple(int(x) for x in c.split("-")) for c in cid_map}
    got = compare.serve_numbers(served, beams, ref_rr, 4, ecfg["score_rates"],
                                cids)
    assert got["malformed"] == got["beam_set_diff"] == 0
    assert got["beam_score_err"] < TOL and got["fused_err"] < TOL
    r = beams.routing
    assert r.decisions > 0 and r.refused == r.followed == 0


# ----------------------------------------------------- route following

def _tie_weights(gap: float):
    """One expert layer's leaves where every token's scores are the
    router's bias alone (a zero router: sigmoid 0.5 + b) with experts 2
    and 5 (k = 3: the 3rd and 4th) ``gap`` apart."""
    model = _model(seed=2)
    w = {k: v.clone() for k, v in model.state_dict().items()}
    p = "stack.blocks.1."
    w[p + "ff.router"].zero_()
    w[p + "ff.score_bias"].copy_(torch.tensor(
        [0.9, 0.0, 0.5, 0.1, 0.8, 0.5 - gap, 0.2, 0.3]))
    return w, _cfg(model), p


@pytest.mark.parametrize("case", ["followed", "refused", "clear"])
def test_route_following_takes_a_near_tie_and_refuses_outside_the_gap(case):
    gap = ref_ds.ROUTE_TIE_GAP
    w, cfg, p = _tie_weights(gap / 4 if case != "clear" else 4 * gap)
    h = torch.randn(1, 3, TINY["d_model"],
                    generator=torch.Generator().manual_seed(1))
    h = h * h.pow(2).mean(-1, keepdim=True).rsqrt()   # RMSNorm(h) = h
    own = [0, 2, 4]                       # the three largest biases
    theirs = {"followed": [0, 4, 5], "refused": [0, 2, 7],
              "clear": [0, 4, 5]}[case]
    asked = []

    def follow(layer, key):
        asked.append((layer, key))
        return theirs

    r = ref_ds.Routing()
    with torch.no_grad():
        got = ref_ds.routed(w, p, cfg, h, 1, lambda n, l: (0, ("p", l)),
                            follow, r)
        want = ref_ds.routed(w, p, cfg, h, 1, None, None, ref_ds.Routing())
        # what the program's set computes, by the plain top-k wrapper
        base = torch.zeros(3, TINY["d_model"])
        sel_bias = w[p + "ff.score_bias"].clone()
        sel_bias[theirs] += 1.0                 # force the program's set
        forced = experts.topk_expert_sublayer_plain(
            h[0], base, torch.ones(TINY["d_model"]), w[p + "ff.router"],
            sel_bias, w[p + "ff.wi"], w[p + "ff.wo"], k=3, scale=2.446,
            eps=1e-30)
    assert r.decisions == 3
    if case == "clear":
        assert r.near == 0 and not asked and torch.equal(got, want)
        return
    assert r.near == 3 and len(asked) == 3
    if case == "followed":
        assert r.followed == 3 and r.refused == 0
        assert not torch.equal(got, want)
        assert float((got[0] - forced).abs().max()) < TOL
    else:
        assert r.refused == 3 and r.followed == 0 and torch.equal(got, want)


# ------------------------------------------------------------- the shape

def test_the_published_preset_and_the_other_backbones():
    cfg = ModelConfig().scaled("moonlight-16b-a3b")
    assert cfg.decoder_only and cfg.num_experts_per_tok == 6
    with torch.device("meta"):
        model = GenerativeRetriever(cfg)
    stack = sum(p.numel() for n, p in model.named_parameters()
                if n.startswith("stack.") or n == "shared.weight")
    # Moonlight-16B-A3B without its lm_head: 15.62 B parameters (the
    # embedding, 27 attention layers with their norms, the dense FFN, 26
    # expert layers of router, score bias, 64 experts and the shared ones,
    # the final norm)
    d, attn = 2048, 2048 * 3072 + 2048 * 576 + 512 + 512 * 4096 + 2048 ** 2
    moe = 64 * d + 64 + 64 * 3 * d * 1408 + 3 * d * 2816
    assert stack == (163840 * d + 27 * (attn + 2 * d) + 3 * d * 11264
                     + 26 * moe + d) == 15_624_565_888
    assert not hasattr(model, "encoder") and not hasattr(model, "decoder")
    for preset in ("tiny", "switch-base"):
        c = ModelConfig().scaled(preset)
        assert not c.decoder_only
        with torch.device("meta"):
            m = GenerativeRetriever(c)
        assert hasattr(m, "encoder") and not hasattr(m, "stack")


def test_training_is_refused():
    model = _model()
    with pytest.raises(NotImplementedError, match="experts"):
        model.cfg.refuse_experts("train_step")
    model.train()
    x = torch.randn(4, TINY["d_model"])
    with pytest.raises(NotImplementedError, match="serve only"):
        model.stack.blocks[1].ff.residual(x, model.stack.blocks[1].ln2)


def test_route_record_of_the_program():
    """A model whose expert layers record: each call appends its chosen
    experts [rows, k], ascending, and its router logits, which choose
    them."""
    model = _model()
    layers = [b.ff for b in model.stack.blocks[1:]]
    for ff in layers:
        ff.record = []
    ids, mask = _queries(1, 6, 7)
    with torch.no_grad():
        model.prefill(ids, mask)
    for ff in layers:
        ((route, logits),) = ff.record
        assert tuple(route.shape) == (6, 3)
        sel, _ = experts.topk_select(logits, ff.score_bias, 3, 2.446)
        assert torch.equal(route.long(), sel)
        ff.record = None
    assert np.unique(route.numpy()).size > 1


# ------------------------------------------------------- the chunk counter

def _chunks(route: torch.Tensor, n_exp: int) -> int:
    load = torch.bincount(route.long().flatten(), minlength=n_exp)
    return int(((load + experts.TOP_CHUNK - 1) // experts.TOP_CHUNK).sum())


@pytest.mark.parametrize("case", ["forced", "routed"])
def test_the_plain_path_counts_its_chunks(case):
    """``moe_chunks`` adds Σ⌈load / 16⌉ a call: loads forced to 1, 3, 4,
    5, 8, 9, 16, 17 and 33 rows (1 to 3 chunks an expert; 33 rows of 16
    experts top-3), or a tiny model's routing of 40 rows; the Switch path
    adds 0."""
    g = torch.Generator().manual_seed(4)
    n_exp, d, dff, k = (16, 64, 32, 3) if case == "forced" else (8, 64, 32, 3)
    if case == "forced":
        rows = forced_rows([1, 3, 4, 5, 8, 9, 16, 17, 33], k, n_exp)
        x, router = forced_inputs(rows, d, n_exp, g, "cpu")
    else:
        x = torch.randn(40, d, generator=g)
        router = 0.3 * torch.randn(n_exp, d, generator=g)
    bias = 0.01 * torch.randn(n_exp, generator=g)
    wi = 0.05 * torch.randn(n_exp, 2 * dff, d, generator=g)
    wo = 0.05 * torch.randn(n_exp, d, dff, generator=g)
    route = torch.empty((x.shape[0], k), dtype=torch.int32)
    kernels.reset_launch_counts()
    experts.topk_expert_sublayer(x, x, torch.ones(d), router, bias, wi, wo,
                                 k=k, scale=2.446, route=route)
    stats = kernels.launch_counts(experts=True)
    if case == "forced":
        assert route.tolist() == rows and _chunks(route, n_exp) == 12 + 3
    assert stats["moe_chunks"] == _chunks(route, n_exp)
    assert stats["moe_assignments"] == x.shape[0] * k
    experts.expert_sublayer(x, torch.ones(d), router, wi[:, :dff], wo,
                            capacity=4, seq_len=x.shape[0])
    assert kernels.launch_counts(experts=True)["moe_chunks"] \
        == _chunks(route, n_exp)
    kernels.reset_launch_counts()


def test_the_chunk_counter_is_a_routing_counter():
    """``launch_counts(experts=True)`` carries ``moe_chunks`` beside the
    other ``moe_`` counters, the default view does not, and a reset zeroes
    it with them."""
    kernels.reset_launch_counts()
    assert "moe_chunks" in experts.STATS
    assert "moe_chunks" in kernels.launch_counts(experts=True)
    assert "moe_chunks" not in kernels.launch_counts()
    experts.stats_tensor(torch.device("cpu")).add_(2)
    assert kernels.launch_counts(experts=True)["moe_chunks"] == 2
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts(experts=True).values())


class _StandIn:
    """A CUDA graph whose capture runs the code and whose replay does
    nothing."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _Stream:
    def wait_stream(self, other):
        pass


def test_a_capture_keeps_the_chunk_counter_with_the_others(monkeypatch):
    """A decode chain captured on the stand-in graph (the capture runs the
    plain expert layer once, as an eager call would count; a replay runs
    nothing): every ``moe_`` counter, ``moe_chunks`` with them, reads one
    call's worth after the capture and after each replay, while the
    registry puts its host counters back and adds the pieces' launches at
    each replay."""
    for name, value in [("CUDAGraph", _StandIn),
                        ("graph_pool_handle", lambda: None),
                        ("current_stream", lambda device=None: _Stream()),
                        ("stream", lambda s: contextlib.nullcontext())]:
        monkeypatch.setattr(torch.cuda, name, value)
    model = _model()
    ff, ln = model.stack.blocks[1].ff, model.stack.blocks[1].ln2
    x = torch.randn(12, TINY["d_model"], generator=torch.Generator()
                    .manual_seed(6))
    route = torch.empty((12, 3), dtype=torch.int32)

    def layer(ids, mask):
        with torch.no_grad():
            experts.topk_expert_sublayer(
                x, x, ln.scale, ff.router, ff.score_bias, ff.wi, ff.wo, k=3,
                scale=2.446, route=route)
        timing.count("topk_expert_sublayer")
        yield torch.tensor(True), None
        return None, ids, mask

    kernels.reset_launch_counts()
    ids, mask = torch.ones(1, 3), torch.ones(1, 3)
    chain = decode_graphs._Chain(layer, ids, mask, 2, _Stream())
    once = {k: v for k, v in kernels.launch_counts(experts=True).items()
            if k.startswith("moe_")}
    assert once["moe_calls"] == 1 and once["moe_chunks"] == _chunks(route, 8)
    assert timing.counts()["topk_expert_sublayer"] == 0
    for i in (1, 2):
        chain.replay(ids, mask)
        counts = kernels.launch_counts(experts=True)
        assert {k: counts[k] for k in once} == once
        assert counts["topk_expert_sublayer"] == i
    kernels.reset_launch_counts()
