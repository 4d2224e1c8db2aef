"""The port's Switch Transformer generator on the CPU (its plain versions):
the encoder against ``transformers``' ``SwitchTransformersEncoderModel``
through the HF converter, with a capacity that drops tokens; the cached
decode and a whole ``Evaluator.retrieve`` against the benchmark's plain
reference (``gdrbench/reference/switch.py``), which recomputes the decoder
over each beam's whole prefix; the routing counters of a hand-set routing;
dense models built as before; and the refusals where experts are not
ported (training, the column-parallel placement, bf16 on the card).

The file imports neither JAX nor the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gdr_tpu_torch import kernels
from gdr_tpu_torch.config import EvalConfig, GDRConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.kernels import build, experts
from gdr_tpu_torch.models import convert
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.models.t5 import FeedForward, RoutedFeedForward
from gdr_tpu_torch.ops.trie import build_trie
from gdrbench import compare, weights
from gdrbench.reference import model as M
from gdrbench.reference import serve as ref_serve
from gdrbench.reference import switch as ref_switch
from gdrbench.traffic.world import bench_cid_map, unit_store

TOL = 1e-5      # the f32 tolerance of the port's CPU paths against a plain one
TINY = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_decoder_layers=2, num_heads=4, kary=4, max_output_length=5,
            adaptor_layer_num=1, adaptor_num_heads=2, encoder_d_model=32,
            dropout_rate=0.0, num_experts=4, encoder_sparse_step=2,
            decoder_sparse_step=2)


def _model(capacity: int, seed: int = 0) -> GenerativeRetriever:
    torch.manual_seed(seed)
    model = GenerativeRetriever(ModelConfig(**TINY, expert_capacity=capacity))
    return init_weights(model, torch.Generator().manual_seed(seed)).eval()


def _queries(batch: int, seq: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(2, TINY["vocab_size"], (batch, seq), generator=g)
    mask = torch.ones_like(ids)
    mask[-1, seq - 3:] = 0                       # one query with padding
    return ids, mask


def _stats() -> dict[str, int]:
    return {k: v for k, v in kernels.launch_counts(experts=True).items()
            if k.startswith("moe_")}


# ------------------------------------------------------------ transformers

@pytest.fixture(scope="module")
def switch_dir(tmp_path_factory):
    from transformers import SwitchTransformersConfig
    from transformers import SwitchTransformersEncoderModel

    torch.manual_seed(3)
    cfg = SwitchTransformersConfig(
        vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=4,
        num_sparse_encoder_layers=2, num_decoder_layers=2,
        num_sparse_decoder_layers=1, num_heads=4, num_experts=4,
        expert_capacity=3, dropout_rate=0.0, router_jitter_noise=0.0)
    hf = SwitchTransformersEncoderModel(cfg).eval()
    with torch.no_grad():      # routers as published: N(0, 1)
        for name, p in hf.named_parameters():
            if "router" in name:
                p.normal_()
    path = tmp_path_factory.mktemp("hf_switch")
    hf.save_pretrained(str(path))
    return str(path), hf


def test_switch_encoder_matches_transformers(switch_dir):
    path, hf = switch_dir
    over = convert.t5_model_overrides(path)
    assert {k: over[k] for k in ("num_experts", "expert_capacity",
                                 "encoder_sparse_step",
                                 "decoder_sparse_step")} == dict(
        num_experts=4, expert_capacity=3, encoder_sparse_step=2,
        decoder_sparse_step=2)
    cfg = ModelConfig(**{**TINY, **over, "num_decoder_layers": 2})
    model = GenerativeRetriever(cfg).eval()
    sd = convert.read_state_dict(path)
    convert.load_t5_encoder(model, sd, cfg.num_layers)
    ids, mask = _queries(3, 16, 5)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = model.encode(ids, mask)
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
    assert float((got - want).abs().max()) < TOL
    stats = _stats()
    assert stats["moe_calls"] == 2 and stats["moe_dropped"] > 0
    back = convert.export_t5_encoder(model.state_dict(), cfg.num_layers, 4, 2)
    assert back.keys() <= sd.keys()
    assert all(np.array_equal(v, sd[k].numpy()) for k, v in back.items())
    assert "encoder.block.1.layer.1.mlp.experts.expert_3.wo.weight" in back


def test_t5_overrides_keep_no_expert_fields(tmp_path):
    (tmp_path / "config.json").write_text('{"d_model": 32, "num_layers": 2}')
    assert "num_experts" not in convert.t5_model_overrides(str(tmp_path))


# ------------------------------------------------------- plain reference

def _ref_cfg(model) -> dict:
    return dataclasses.asdict(model.cfg)


@pytest.mark.parametrize("capacity", [64, 1], ids=["kept", "dropping"])
def test_cached_decode_matches_the_full_prefix_reference(capacity):
    """Each step's candidate logits of the cached decode, three rows a
    query, equal the reference's decoder recomputed over the prefix; at
    capacity 1 a beam's second token to an expert adds 0 in both."""
    model = _model(capacity)
    w, cfg = dict(model.state_dict()), _ref_cfg(model)
    ids, mask = _queries(2, 12, 1)
    beams, steps = 3, 5
    g = torch.Generator().manual_seed(4)
    tokens = torch.zeros((2 * beams, steps), dtype=torch.long)
    for p in range(1, steps):
        tokens[:, p] = (p - 1) * TINY["kary"] + 2 + torch.randint(
            0, TINY["kary"], (2 * beams,), generator=g)
    kernels.reset_launch_counts()
    with torch.no_grad():
        enc = model.encode(ids, mask)
        ref_enc = ref_switch.encode(w, cfg, ids, mask)
        assert float((enc - ref_enc).abs().max()) < TOL
        cache = model.init_cache(enc, steps, beams)
        cache["cross_ucand"] = model.decode_tables(steps)
        for pos in range(steps):
            got, cache = model.decode_step_candidates(
                tokens[:, pos].int(), cache, mask, pos, beams)
            prefix = tokens[:, :pos + 1]
            hid = ref_switch.decode(w, cfg, prefix, ref_enc, mask)[:, pos]
            ada = M.pawa(w, cfg, prefix)[:, pos]
            want = M.candidate_logits(w, cfg, hid, ada, pos)
            assert float((got - want).abs().max()) < TOL, pos
    dropped = _stats()["moe_dropped"]
    assert (dropped > 0) == (capacity == 1)


def test_retrieve_matches_the_reference():
    """A whole ``Evaluator.retrieve`` (packed store, beam 8) of a model
    whose encoder drops tokens: the reference's beams, scores and fused
    scores."""
    model = _model(2, seed=1)
    w, cfg = dict(model.state_dict()), _ref_cfg(model)
    cid_map = bench_cid_map(200, 4, 4)
    trie = build_trie(cid_map, 4, max_docs_per_cluster=4)
    store = unit_store(200, 32, 9, "cpu")
    ecfg = dict(num_beams=8, num_return_sequences=8, max_output_length=5,
                length_penalty=0.8, score_rates=[0.0, 1.0, 2.5])
    ev = Evaluator(model, trie, store.numpy(), EvalConfig(**ecfg),
                   packed=True)
    ids, mask = _queries(3, 12, 2)
    kernels.reset_launch_counts()
    res, rr = ev.retrieve(ids.numpy(), mask.numpy())
    assert _stats()["moe_dropped"] > 0
    served = {"doc_ids": rr.doc_ids.numpy(), "fused": rr.scores.numpy(),
              "sequences": res.sequences.numpy(),
              "beam_scores": res.scores.numpy(), "valid": res.valid.numpy()}
    max_len = min(5, max(len(c.split("-")) for c in cid_map) + 1)
    with torch.no_grad():
        beams, ref_rr = ref_switch.retrieve(
            w, cfg, ecfg, store, ref_serve.Trie(cid_map, 4), cid_map, ids,
            mask, max_len)
    cids = {tuple(int(x) for x in c.split("-")) for c in cid_map}
    got = compare.serve_numbers(served, beams, ref_rr, 4, ecfg["score_rates"],
                                cids)
    assert got["malformed"] == got["beam_set_diff"] == 0
    assert got["beam_score_err"] < TOL and got["fused_err"] < TOL
    assert np.all(beams.route_gap > 0)


# ------------------------------------------------------------- counters

def test_routing_counters_of_a_hand_set_routing():
    """Rows routed by hand: x_r = e_k makes h_r = √d·e_k, and router row j
    is the indicator of the inputs sent to j.  One sequence of 6 tokens to
    experts 0, 0, 0, 1, 2, 0 at capacity 2: tokens 3 and 6 dropped, 3
    experts hit, at most 2 rows on one, and ``counts`` takes all 6."""
    d, n_exp, dff = 8, 4, 16
    route = [0, 0, 0, 1, 2, 0]
    x = torch.zeros(6, d)
    x[torch.arange(6), torch.arange(6)] = 1.0
    router = torch.zeros(n_exp, d)
    router[route, torch.arange(6)] = 1.0
    g = torch.Generator().manual_seed(0)
    wi = torch.randn(n_exp, dff, d, generator=g)
    wo = torch.randn(n_exp, d, dff, generator=g)
    counts = torch.zeros(1, n_exp, dtype=torch.int32)
    kernels.reset_launch_counts()
    out = experts.expert_sublayer(x, torch.ones(d), router, wi, wo,
                                  capacity=2, seq_len=6, counts=counts)
    assert _stats() == dict(moe_calls=1, moe_rows=6, moe_experts_hit=3,
                            moe_max_load=2, moe_dropped=2, moe_assignments=6,
                            moe_chunks=0, moe_held=6)
    assert counts.tolist() == [[4, 1, 1, 0]]
    assert torch.equal(out[[2, 5]], x[[2, 5]])          # dropped: x alone
    assert not torch.equal(out[[0, 1, 3, 4]], x[[0, 1, 3, 4]])
    # a second call of the same sequence starts from its counts: expert 0
    # is full, experts 1 and 2 take one more each
    experts.expert_sublayer(x, torch.ones(d), router, wi, wo, capacity=2,
                            seq_len=6, counts=counts)
    assert _stats()["moe_dropped"] == 2 + 4
    kernels.reset_launch_counts()
    assert not any(_stats().values())


# ------------------------------------------------------- dense unchanged

@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_dense_models_build_as_before(preset):
    cfg = ModelConfig().scaled(preset)
    with torch.device("meta"):
        model = GenerativeRetriever(cfg)
    assert not any(isinstance(m, RoutedFeedForward) for m in model.modules())
    assert all(isinstance(b.ff, FeedForward)
               for b in (*model.encoder.blocks, *model.decoder.blocks))
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} \
        == weights.param_shapes(dataclasses.asdict(cfg))
    with torch.device("meta"):
        cache = model.init_cache(torch.zeros(1, 4, cfg.d_model), 3, 2)
    assert not [k for k in cache if k.startswith("moe_")]


def test_switch_base_preset():
    cfg = ModelConfig().scaled("switch-base")
    with torch.device("meta"):
        model = GenerativeRetriever(cfg)
    routed = [i for i, b in enumerate(model.encoder.blocks)
              if isinstance(b.ff, RoutedFeedForward)]
    assert routed == [1, 3, 5, 7, 9, 11]
    assert [i for i, b in enumerate(model.decoder.blocks) if b.routed] \
        == [1, 3, 5]
    n = sum(p.numel() for p in model.parameters())
    assert 5.7e9 < n < 5.8e9
    assert model.encoder.blocks[1].ff.wi.shape == (128, 3072, 768)


def test_a_dense_cpu_retrieve_loads_no_expert_library():
    model = GenerativeRetriever(ModelConfig(**{**TINY, "num_experts": 0}))
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    trie = build_trie(bench_cid_map(60, 4, 4), 4, max_docs_per_cluster=4)
    ev = Evaluator(model, trie, unit_store(60, 32, 1, "cpu").numpy(),
                   EvalConfig(num_beams=4, num_return_sequences=4,
                              max_output_length=5), packed=True)
    kernels.reset_launch_counts()
    ev.retrieve(*(t.numpy() for t in _queries(2, 8, 1)))
    assert "experts" not in build._libs
    assert not any(_stats().values())


# ------------------------------------------------------------- refusals

def test_training_refuses_experts():
    from gdr_tpu_torch.train.loop import TrainLoop
    from gdr_tpu_torch.train.trainer import make_train_step
    cfg = GDRConfig(model=ModelConfig(**TINY))
    with pytest.raises(NotImplementedError, match="sparse experts"):
        TrainLoop(cfg, None, None, None, "unused", device="cpu")
    with pytest.raises(NotImplementedError, match="sparse experts"):
        make_train_step(_model(2), None, None, cfg)
    model = _model(2).train()
    with pytest.raises(NotImplementedError, match="serve only"):
        model.encode(*_queries(1, 4, 0))


def test_column_parallel_placement_refuses_experts():
    from gdr_tpu_torch.parallel.mesh import tp_param_rules
    rule = tp_param_rules(2, min_size=1)
    assert rule("generator/encoder.blocks.0.ff.wi.weight",
                torch.zeros(64, 32)) is not None
    for leaf in ("router", "wi", "wo"):
        with pytest.raises(NotImplementedError, match="column-parallel"):
            rule(f"generator/encoder.blocks.1.ff.{leaf}",
                 torch.zeros(4, 64, 32))


def test_bf16_experts_off_the_cpu_are_refused():
    """The card's experts serve f32 only; the refusal comes before any
    launch (shown on meta tensors, which are not the CPU's either)."""
    with torch.device("meta"):
        x = torch.zeros(4, 32, dtype=torch.bfloat16)
        args = [torch.zeros(s, dtype=torch.bfloat16)
                for s in ((32,), (4, 32), (4, 64, 32), (4, 32, 64))]
    with pytest.raises(TypeError, match="float32 models only"):
        experts.expert_sublayer(x, *args, capacity=2, seq_len=4)
