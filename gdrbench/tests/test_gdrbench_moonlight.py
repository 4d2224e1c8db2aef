"""The Moonlight cell's files: the configuration holds the published
numbers and the port's model block agrees with them, the weights are drawn
into the port's leaves, the costs follow from shapes and counters, a tiny
copy of the cell runs whole on the CPU and comes out correct (the
reference following the program's routing), and a planted fault in the
experts makes it not correct."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from conftest import REPO, TINY_MODEL, _tiny, execute
from gdrbench import costs, costs_moonlight, harness

CELL = "serve-b1-moonlight"
CONFIG = json.loads((REPO / "gdrbench/configs/gdr-moonlight-16b-a3b-f32.json")
                    .read_text())
TINY_MOON = dict(TINY_MODEL, backbone="deepseek_v3", d_model=64, num_layers=3,
                 num_heads=2, d_ff=96, kv_lora_rank=32, qk_nope_head_dim=16,
                 qk_rope_head_dim=8, v_head_dim=16, num_experts=8,
                 moe_d_ff=32, num_experts_per_tok=3, num_shared_experts=1,
                 first_k_dense=1)


@pytest.fixture
def moon_root(tmp_path):
    """A checkout root with ``tiny-moonlight``: the cell at width 64, eight
    experts top-3, one query a retrieve, 4 retrieves compared."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "gdrbench", root / "gdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec(REPO)
    _tiny(root, spec, "tiny-moonlight", "gdr-moonlight-16b-a3b-f32", CELL,
          TINY_MOON, {"eval": dict(num_beams=8, num_return_sequences=8,
                                   max_output_length=5)},
          dict(check_requests=4, trace_requests=2, max_requests_per_s=200))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-moonlight")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_the_configuration_is_the_published_one():
    m = CONFIG["model"]
    assert CONFIG["reduced"] == [] and CONFIG["model_type"] == "deepseek_v3"
    pairs = {"hidden_size": "d_model", "num_hidden_layers": "num_layers",
             "num_attention_heads": "num_heads", "intermediate_size": "d_ff",
             "kv_lora_rank": "kv_lora_rank",
             "qk_nope_head_dim": "qk_nope_head_dim",
             "qk_rope_head_dim": "qk_rope_head_dim",
             "v_head_dim": "v_head_dim", "rope_theta": "rope_theta",
             "rms_norm_eps": "layer_norm_epsilon",
             "n_routed_experts": "num_experts",
             "moe_intermediate_size": "moe_d_ff",
             "num_experts_per_tok": "num_experts_per_tok",
             "n_shared_experts": "num_shared_experts",
             "first_k_dense_replace": "first_k_dense",
             "routed_scaling_factor": "routed_scaling_factor",
             "vocab_size": "vocab_size"}
    assert all(CONFIG[k] == m[v] for k, v in pairs.items())
    assert CONFIG["q_lora_rank"] is None and CONFIG["n_group"] == 1
    assert CONFIG["scoring_func"] == "sigmoid" and CONFIG["norm_topk_prob"]


def test_expected_launches_of_the_cell():
    drv = harness.cell(harness.load_spec(REPO), CELL, REPO).driver
    assert drv.expected_launches(CONFIG["model"], 4) == {
        "mla_attention": 108, "topk_expert_sublayer": 130,
        "packed_scores": 1}


def test_costs_of_the_counters_and_shapes():
    m = CONFIG["model"]
    stats = dict(moe_calls=26, moe_rows=2600, moe_experts_hit=1600,
                 moe_assignments=15600)
    flops, nbytes = costs_moonlight.topk_expert_cost(m, stats)
    assert flops == 2 * 2600 * 2048 * 64 + 6 * 15600 * 2048 * 1408
    assert nbytes == (1600 * 3 * 2048 * 1408 + 26 * (64 * 2048 + 64)
                      + 2600 * 2 * 2048) * 4
    # ~10 assignments an expert: the bytes bound it
    assert costs_moonlight.topk_expert_bound_s(m, stats) == pytest.approx(
        nbytes / costs.H100_BYTES)
    f, b = costs_moonlight.mla_cost(m, 1, 100, 3, 40)
    assert f == 2 * 100 * 16 * 44 * (192 + 128)
    # the prefix once; each row's q, k_pe, kv_b, its 4 cached steps, its
    # new key and value and its output; the rope table
    assert b == 4 * (16 * 40 * 320 + 41 + 100 * (3072 + 64 + 4096
                                                 + 4 * 16 * 320 + 16 * 448)
                     + 32)
    # the experts and the dense layer dominate a token's FLOPs
    assert costs_moonlight.token_flops(m, 40) == pytest.approx(
        2 * 2.5e9, rel=0.3)
    assert costs_moonlight.retrieve_flops(m, 1, 100, 4, 40, 30) > \
        232 * costs_moonlight.token_flops(m, 40)


def test_weights_are_drawn_into_the_ports_leaves():
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever
    from gdrbench.weights_moonlight import BIAS_STD, ROUTER_STD, draw_into
    cfg = ModelConfig(**dict(TINY_MOON, num_experts=64, d_model=128))
    a, b = GenerativeRetriever(cfg), GenerativeRetriever(cfg)
    wa, wb = draw_into(a, 2**35), draw_into(b, 2**35)
    assert all(torch.equal(wa[n], wb[n]) for n in wa)
    assert wa["stack.blocks.1.ff.router"] is a.stack.blocks[1].ff.router
    std = {n: float(p.detach().std()) for n, p in wa.items()}
    assert std["stack.blocks.1.ff.router"] == pytest.approx(ROUTER_STD,
                                                            rel=0.1)
    assert std["stack.blocks.2.ff.score_bias"] == pytest.approx(BIAS_STD,
                                                                rel=0.4)
    assert torch.equal(wa["stack.blocks.0.attn.kv_norm.scale"],
                       torch.ones(32))


def test_moonlight_run_matches_reference(moon_root):
    r = execute(moon_root, "tiny-moonlight", 2**33 + 9)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"malformed", "beam_set_diff",
                                "beam_score_err", "fused_err", "top_r_gap",
                                "route_refused", "selection_err"}
    assert r["checks"]["beam_score_err"]["value"] < 1e-5
    info = r["info"]
    assert info["compared_queries"] == min(4, info["retrieves"])
    assert info["route_decisions"] > 0 and info["route_unmatched"] == 0
    assert 0 <= info["route_follow_share"] < 0.5
    assert set(r["metrics"]) == {"setup_s", "retrieve_p95_ms",
                                 "queries_per_s"}


def test_moonlight_traced_run_reports_layer_metrics(moon_root):
    r = execute(moon_root, "tiny-moonlight", 12, trace=True)
    assert r["correct"], r["checks"]
    # no device here: the trace-derived metrics find nothing to read
    assert set(r["metrics"]) == {"mfu.serve"}
    # two retrieves: a prefill and four steps at each of two expert layers
    routing = r["info"]["routing_traced"]
    assert routing["moe_calls"] == 2 * 2 * (1 + 4)
    assert routing["moe_assignments"] == 3 * routing["moe_rows"]


def test_moonlight_fault_is_not_correct(moon_root, monkeypatch):
    """Experts whose weights are not normalised: the program's answers
    move off the reference's."""
    from gdr_tpu_torch.kernels import experts
    real = experts.topk_expert_sublayer_plain

    def unnormalised(x, base, *a, **k):
        out = real(x, base, *a, **k)
        return base + 1.5 * (out - base)
    monkeypatch.setattr(experts, "topk_expert_sublayer_plain", unnormalised)
    r = execute(moon_root, "tiny-moonlight", 7)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_the_tf32_control_fails_on_the_card():
    """``control_moonlight.py`` at the cell's own size: the reference in
    TF32 comes out not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gdrbench import control_moonlight
    cell = harness.cell(harness.load_spec(REPO), CELL, REPO)
    row = control_moonlight.control(cell, 101, torch.device("cuda:0"))
    assert not row["correct"], row


def test_the_rerank_control_keeps_beam_sets_and_reads_the_rerank(moon_root):
    """``control_moonlight.py --fault rerank`` on the tiny cell: the f32
    reference's own beams, so no beam set differs and the beams' scores
    agree exactly, while the TF32 re-rank moves the fused scores."""
    from gdrbench import control_moonlight
    cell = harness.cell(harness.load_spec(moon_root), "tiny-moonlight",
                        moon_root)
    row = control_moonlight.rerank_control(cell, 2**33 + 5,
                                           torch.device("cpu"))
    checks = row["checks"]
    assert checks["beam_set_diff"] == checks["malformed"] == 0, row
    assert checks["beam_score_err"] == checks["route_refused"] == 0, row
    assert checks["fused_err"] > 0, row
    assert row["compared_queries"] > 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from gdrbench.control_moonlight import to_tf32
    x = torch.tensor([1.0, 1 + 2.0**-10, 1 + 2.0**-11, 1 + 2.0**-12, -3.0,
                      -(1 + 2.0**-11)])
    assert to_tf32(x).tolist() == [1.0, 1 + 2.0**-10, 1 + 2.0**-10, 1.0,
                                   -3.0, -(1 + 2.0**-10)]
