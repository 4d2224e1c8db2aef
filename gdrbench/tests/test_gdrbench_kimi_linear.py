"""The Kimi Linear cell's files: the configuration holds the catalog's
published numbers with the experts cut to card 0's share, the port's
preset agrees with it, the weights are drawn into the port's leaves, the
costs follow from shapes and counters, a tiny copy of the cell runs whole
on the CPU and comes out correct (the reference following the program's
routing), its traced run reads the layer metrics it can, and the KDA
states left unreordered make it not correct."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from conftest import REPO, TINY_MODEL, _tiny, execute
from gdrbench import costs, costs_kimi_linear, harness

CELL = "serve-b1-kimi-linear"
CONFIG = json.loads((REPO / "gdrbench/configs/"
                     "gdr-kimi-linear-48b-a3b-ep8-f32.json").read_text())
TINY_KIMI = dict(TINY_MODEL, backbone="kimi_linear", d_model=64,
                 num_layers=4, num_heads=2, d_ff=96, kv_lora_rank=32,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                 num_experts=16, experts_held=8, expert_offset=4,
                 moe_d_ff=32, num_experts_per_tok=4, num_shared_experts=1,
                 first_k_dense=1, kda_layers=[1, 2, 3], full_attn_layers=[4],
                 kda_num_heads=2, kda_head_dim=16)


@pytest.fixture
def kimi_root(tmp_path):
    """A checkout root with ``tiny-kimi``: the cell at width 64, 16 experts
    top-4 of which 8 held, one query a retrieve, 4 retrieves compared."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "gdrbench", root / "gdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec(REPO)
    _tiny(root, spec, "tiny-kimi", "gdr-kimi-linear-48b-a3b-ep8-f32", CELL,
          TINY_KIMI, {"eval": dict(num_beams=8, num_return_sequences=8,
                                   max_output_length=5)},
          dict(check_requests=4, trace_requests=2, max_requests_per_s=200))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-kimi")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_the_configuration_is_the_catalogs_with_card_0s_experts():
    from gdr_tpu_torch.config import ModelConfig
    m = CONFIG["model"]
    assert CONFIG["reduced"] == ["num_experts"]
    assert CONFIG["num_experts"] == m["experts_held"] == 32
    assert CONFIG["published_num_experts"] == m["num_experts"] == 256
    assert m["expert_offset"] == 0 and "8 H100s" in CONFIG["deployment"]
    lin = CONFIG["linear_attn_config"]
    pairs = {"hidden_size": "d_model", "num_hidden_layers": "num_layers",
             "num_attention_heads": "num_heads", "intermediate_size": "d_ff",
             "kv_lora_rank": "kv_lora_rank",
             "qk_nope_head_dim": "qk_nope_head_dim",
             "qk_rope_head_dim": "qk_rope_head_dim",
             "v_head_dim": "v_head_dim", "rms_norm_eps": "layer_norm_epsilon",
             "moe_intermediate_size": "moe_d_ff",
             "num_experts_per_token": "num_experts_per_tok",
             "num_shared_experts": "num_shared_experts",
             "first_k_dense_replace": "first_k_dense",
             "routed_scaling_factor": "routed_scaling_factor",
             "vocab_size": "vocab_size", "mla_use_nope": "mla_use_nope"}
    assert all(CONFIG[k] == m[v] for k, v in pairs.items())
    assert (lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
            ) == (m["kda_num_heads"], m["kda_head_dim"], m["kda_conv_size"])
    assert lin["kda_layers"] == m["kda_layers"]
    assert lin["full_attn_layers"] == m["full_attn_layers"]
    preset = ModelConfig().scaled("kimi-linear-48b-a3b")
    assert all(getattr(preset, k) == (tuple(v) if isinstance(v, list) else v)
               for k, v in m.items() if k in ModelConfig.__dataclass_fields__
               and k not in ("dropout_rate", "max_output_length", "kary",
                             "encoder_d_model", "adaptor_layer_num",
                             "adaptor_num_heads", "adaptor_d_ff", "position",
                             "tie_decode_embedding", "adaptor_decode",
                             "adaptor_efficient"))


def test_expected_launches_of_the_cell():
    drv = harness.cell(harness.load_spec(REPO), CELL, REPO).driver
    assert drv.expected_launches(CONFIG["model"], 4) == {
        "kda_prefill": 20, "kda_decode": 80, "mla_attention": 28,
        "topk_expert_sublayer": 130, "packed_scores": 1}


def test_costs_of_the_kda_calls_and_the_held_experts():
    m = CONFIG["model"]
    state, window = 32 * 128 * 128, 3 * 3 * 4096
    tok = 12288 + 288 + 4096
    weights = 2 * 4096 * 128 + 12288 * 4 + 32 + 4096 + 128
    # 100 rows continuing 31 beams: each source's state and window read once
    f, b = costs_kimi_linear.kda_decode_cost(m, 100, 31)
    assert b == 4 * ((31 + 100) * (state + window) + 100 * tok + weights)
    assert f / costs.H100_F32_FLOPS < b / costs.H100_BYTES   # bytes bound
    # at step 0 the rows read their query's one prefix state
    _, b0 = costs_kimi_linear.kda_decode_cost(m, 1, 1)
    assert b0 == 4 * (2 * (state + window) + tok + weights)
    # the prefill counts the real tokens, not the pads
    _, bp = costs_kimi_linear.kda_prefill_cost(m, 1, 14)
    assert bp == 4 * (14 * tok + state + window + weights)
    # a retrieve's counters: 20 layers, steps of 1, 31, 100, 100 rows
    counts = dict(kda_prefill=20, kda_decode=80,
                  kda_state_rows=20 * 232, kda_source_rows=20 * (1 + 1 + 31
                                                                 + 60),
                  kda_prefill_tokens=20 * 14)
    bound = costs_kimi_linear.kda_bound_s(m, counts, 1)
    calls = [(1, 1), (31, 1), (100, 31), (100, 60)]
    each = 20 * sum(costs_kimi_linear._bound(
        costs_kimi_linear.kda_decode_cost(m, r, n)) for r, n in calls)
    pre = costs_kimi_linear._bound(costs_kimi_linear.kda_prefill_cost(
        m, 20, 20 * 14, 20))
    assert bound == pytest.approx(each + pre)
    assert bound == pytest.approx(20 * (325 * 2.25e6 + 1.4e6) / 3.35e12,
                                  rel=0.1)
    stats = dict(moe_calls=26, moe_rows=2600, moe_experts_hit=800,
                 moe_assignments=20800, moe_held=2600)
    assert costs_kimi_linear.topk_expert_bound_s(m, stats) == pytest.approx(
        4 * (800 * 3 * 2304 * 1024 + 26 * (256 * 2304 + 256)
             + 2600 * 2 * 2304) / costs.H100_BYTES)
    # the seven MLA layers alone
    assert costs_kimi_linear.mla_bound_s(m, 1, 100, 4, 40) * 27 \
        == pytest.approx(7 * costs_kimi_linear.costs_moonlight.mla_bound_s(
            m, 1, 100, 4, 40))
    # a token's FLOPs: one of the 8 routed experts a token held here
    per_token = costs_kimi_linear.token_flops(m, 40)
    assert per_token == pytest.approx(2 * 1.36e9, rel=0.25)


def test_the_stacks_products_and_their_bound():
    """Every ``gemm`` call of a pass: 3 a KDA layer, 4 an MLA layer, 2 the
    dense FFN and 2 each layer's shared expert, 142 a pass and 710 a
    retrieve's five; at 100 rows the qkv product is bound by its FLOPs,
    at one row every product by its weights."""
    m = CONFIG["model"]
    gemms = costs_kimi_linear.stack_gemms(m)
    assert len(gemms) == 20 * 3 + 7 * 4 + 2 + 26 * 2 == 142
    weights = sum(n * k for n, k, _ in gemms)
    one_row = sum(costs_kimi_linear._gemm_bound(1, n, k, e)
                  for n, k, e in gemms)
    assert one_row == pytest.approx(4 * weights / costs.H100_BYTES, rel=1e-3)
    assert costs_kimi_linear._gemm_bound(100, 12288, 2304, "round") \
        == pytest.approx(2 * 100 * 12288 * 2304 / costs.H100_F32_FLOPS)
    per_pass = [sum(costs_kimi_linear._gemm_bound(r, n, k, e)
                    for n, k, e in gemms) for r in (40, 1, 31, 100, 100)]
    assert costs_kimi_linear.decoder_bound_s(m, 1, 100, 4, 40) \
        == pytest.approx(sum(per_pass))


def test_weights_are_drawn_into_the_ports_leaves():
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever
    from gdrbench.weights_kimi_linear import draw_into
    cfg = ModelConfig(**TINY_KIMI)
    a, b = GenerativeRetriever(cfg), GenerativeRetriever(cfg)
    wa, wb = draw_into(a, 2**35), draw_into(b, 2**35)
    assert all(torch.equal(wa[n], wb[n]) for n in wa)
    p = "stack.blocks.0.attn."
    assert wa[p + "conv"] is a.stack.blocks[0].attn.conv
    assert float(wa[p + "conv"].detach().abs().max()) <= 0.5
    a_log = wa[p + "A_log"].exp()
    assert bool(((a_log >= 1) & (a_log <= 16)).all())
    dt = torch.nn.functional.softplus(wa[p + "dt_bias"])
    assert bool(((dt > 0.9e-3) & (dt < 0.11)).all())
    assert torch.equal(wa[p + "o_norm.scale"], torch.ones(16))
    assert tuple(wa["stack.blocks.1.ff.wi"].shape) == (8, 64, 64)


def test_kimi_run_matches_reference(kimi_root):
    r = execute(kimi_root, "tiny-kimi", 2**33 + 9)
    assert r["correct"], r["checks"]
    assert r["checks"]["beam_score_err"]["value"] < 1e-5
    info = r["info"]
    assert info["compared_queries"] == min(4, info["retrieves"])
    assert info["route_decisions"] > 0 and info["route_unmatched"] == 0
    assert set(r["metrics"]) == {"setup_s", "retrieve_p95_ms",
                                 "queries_per_s"}


def test_kimi_traced_run_reports_layer_metrics(kimi_root):
    r = execute(kimi_root, "tiny-kimi", 12, trace=True)
    assert r["correct"], r["checks"]
    # no device here: the trace-derived metrics find nothing to read
    assert set(r["metrics"]) == {"mfu.serve"}
    routing = r["info"]["routing_traced"]
    assert routing["moe_calls"] == 2 * 3 * (1 + 4)
    assert 0 < routing["moe_held"] < routing["moe_assignments"]
    # the KDA counters of the two traced retrieves (the wrappers count the
    # card's launches alone): 3 KDA layers, steps of 1, 5, 8, 8 rows; at
    # step 0 each row reads its query's prefix state
    kda = r["info"]["kda_traced"]
    assert (kda["kda_prefill"], kda["kda_decode"]) == (0, 0)
    assert kda["kda_state_rows"] == 2 * 3 * (1 + 5 + 8 + 8)
    assert 2 * 3 * 4 <= kda["kda_source_rows"] <= 2 * 3 * (1 + 1 + 5 + 8)
    # the queries' real tokens (3, 6 or 12 each), at every KDA layer
    assert kda["kda_prefill_tokens"] % 3 == 0
    assert 2 * 3 * 3 <= kda["kda_prefill_tokens"] <= 2 * 3 * 12


def test_unreordered_states_are_not_correct(kimi_root):
    """Every beam row keeping its own slot's KDA state, not its source
    beam's: the program's answers move off the reference's."""
    from gdrbench import control_kimi_linear
    with control_kimi_linear.unreordered_states():
        r = execute(kimi_root, "tiny-kimi", 7)
    assert not r["correct"], r["checks"]


def test_the_moonlight_driver_is_left_as_it_was():
    """The Kimi driver replaces ``serve_moonlight.py``'s parts while it
    runs and puts them back."""
    from gdrbench.drivers import serve_kimi_linear, serve_moonlight
    before = {k: getattr(serve_moonlight, k) for k in (
        "build", "expected_launches", "costs_moonlight", "ref_ds")}
    with serve_kimi_linear.kimi():
        assert serve_moonlight.ref_ds.__name__.endswith("kimi_linear")
    assert before == {k: getattr(serve_moonlight, k) for k in before}
