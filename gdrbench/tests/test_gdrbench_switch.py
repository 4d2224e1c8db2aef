"""The Switch Transformer cell's files: its weights are the port's leaves,
its costs follow from the routing counters, a tiny copy of the cell runs
whole on the CPU and comes out correct, a planted fault in the experts
makes it not correct, and a query with a router tie is left out of the
numeric comparisons but not of ``malformed``."""

from __future__ import annotations

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from conftest import REPO, TINY_MODEL, _tiny, execute
from gdrbench import costs, costs_experts, harness
from gdrbench.reference import serve as ref_serve
from gdrbench.reference import switch as ref_switch
from gdrbench.weights_switch import make_weights, param_shapes

CELL = "serve-b1-switch128"
CONFIG = json.loads((REPO / "gdrbench/configs/gdr-switch-base-128-f32.json")
                    .read_text())
TINY_SWITCH = dict(TINY_MODEL, num_experts=4, expert_capacity=2,
                   encoder_sparse_step=2, decoder_sparse_step=2)


@pytest.fixture
def switch_root(tmp_path):
    """A checkout root with ``tiny-switch``: the cell at width 32, four
    experts, capacity 2 (the encoder drops tokens), two queries a
    retrieve.  The pool of requests outlasts a short run, so no query is
    compared twice, and 8 retrieves are compared: ``route_tie_share``
    counts 16 distinct queries, not one tied query drawn twice of 6."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "gdrbench", root / "gdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec(REPO)
    _tiny(root, spec, "tiny-switch", "gdr-switch-base-128-f32", CELL,
          TINY_SWITCH, {"eval": dict(num_beams=8, num_return_sequences=8,
                                     max_output_length=5)},
          dict(batch=2, check_requests=8, trace_requests=2,
               max_requests_per_s=200))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-switch")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("model", [TINY_SWITCH, CONFIG["model"]],
                         ids=["tiny", "switch-base-128"])
def test_weights_are_the_ports_leaves(model):
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever
    full = {**dataclasses.asdict(ModelConfig()), **model}
    with torch.device("meta"):
        port = GenerativeRetriever(ModelConfig(**full))
    want = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert param_shapes(full) == want
    routers = [n for n in want if n.endswith(".ff.router")]
    assert len(routers) == (2 if model is TINY_SWITCH else 9)


def test_weights_share_one_draw_and_routers_are_scaled():
    from gdr_tpu_torch.config import ModelConfig
    m = {**dataclasses.asdict(ModelConfig()), **TINY_SWITCH,
         "num_experts": 64, "d_model": 64}
    w = make_weights(m, 2**35, "cpu")
    again = make_weights(m, 2**35, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    r = w["encoder.blocks.1.ff.router"]
    assert float(r.std()) == pytest.approx(0.2, rel=0.2)
    assert float(w["encoder.blocks.1.ff.wi"].std()) == pytest.approx(0.02,
                                                                     rel=0.2)
    assert r.untyped_storage().data_ptr() \
        == w["shared.weight"].untyped_storage().data_ptr()


def test_expert_costs_of_the_counters():
    m = CONFIG["model"]
    stats = dict(moe_calls=18, moe_rows=772, moe_experts_hit=700,
                 moe_max_load=60, moe_dropped=0)
    flops, nbytes = costs_experts.expert_cost(m, stats)
    assert flops == 2 * 772 * 768 * 128 + 4 * 772 * 768 * 3072
    expert = 2 * 768 * 3072 * 4
    assert nbytes == 700 * expert + 18 * (128 * 768 + 768) * 4 \
        + 772 * 2 * 768 * 4
    # memory-bound: the bytes bound it
    assert costs_experts.expert_bound_s(m, stats) == nbytes / costs.H100_BYTES
    # 6 sparse encoder layers x 40 tokens, 3 sparse decoder layers x 232 rows
    assert costs_experts.router_flops(m, 1, 100, 4, 40) \
        == 2 * 768 * 128 * (6 * 40 + 3 * (1 + 31 + 100 + 100))


def test_decoder_bound_leaves_out_the_sparse_layers_ffn():
    m = CONFIG["model"]
    args = (1, 100, 4, 40, 4, costs.H100_F32_FLOPS)
    kw = dict(d=768, heads=12, dkv=64, dff=3072, queries=1, enc_len=40)
    ffn = sum(costs.bound_s(*costs.decoder_cost("ffn_sublayer", r, pos, 4, 4,
                                                **kw), costs.H100_F32_FLOPS)
              for r, pos in costs.beam_steps(1, 100, m["kary"], 4))
    # 3 of the 6 decoder layers route their FFN
    assert costs_experts.decoder_bound_s(m, *args) == pytest.approx(
        costs.decoder_bound_s(m, *args) - 3 * ffn)
    dense = dict(m, decoder_sparse_step=0)
    assert costs_experts.decoder_bound_s(dense, *args) == pytest.approx(
        costs.decoder_bound_s(dense, *args))


def test_expected_launches_of_the_cell():
    drv = harness.cell(harness.load_spec(REPO), CELL, REPO).driver
    assert drv.expected_launches(CONFIG["model"], 4) == {
        "self_attn_sublayer": 24, "cross_attn_sublayer": 24,
        "ffn_sublayer": 12, "expert_sublayer": 18, "packed_scores": 1}


def test_switch_run_matches_reference(switch_root):
    r = execute(switch_root, "tiny-switch", 2**33 + 9)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"malformed", "beam_set_diff",
                                "beam_score_err", "fused_err", "top_r_gap",
                                "route_tie_share"}
    assert r["checks"]["beam_score_err"]["value"] < 1e-5
    # two queries in each of the (up to) eight retrieves compared
    assert r["info"]["compared_queries"] == 2 * min(8, r["info"]["retrieves"])
    assert set(r["metrics"]) == {"setup_s", "retrieve_p95_ms",
                                 "queries_per_s"}


def test_switch_traced_run_reports_layer_metrics(switch_root):
    r = execute(switch_root, "tiny-switch", 12, trace=True)
    assert r["correct"], r["checks"]
    # no device here: the trace-derived metrics find nothing to read
    assert set(r["metrics"]) == {"mfu.serve"}
    assert set(r["info"]["setup_parts_s"]) == {
        "start", "world", "weights", "evaluator", "retrieve_0",
        "retrieve_1", "launch_check"}
    # two retrieves: one encoder call and four steps each (the tiny world's
    # trie is 3 deep)
    routing = r["info"]["routing_traced"]
    assert routing["moe_calls"] == 2 * (1 + 4) and routing["moe_dropped"] > 0


def test_switch_fault_is_not_correct(switch_root, monkeypatch):
    """Experts that forget π: the program's answers move off the
    reference's."""
    from gdr_tpu_torch.kernels import experts
    real = experts.expert_sublayer_plain

    def no_pi(x, *a, **k):
        out = real(x, *a, **k)
        return x + 2.0 * (out - x)
    monkeypatch.setattr(experts, "expert_sublayer_plain", no_pi)
    r = execute(switch_root, "tiny-switch", 7)
    assert not r["correct"], r["checks"]


def _answer(cids, scores):
    """A served answer of one query holding ``cids`` with ``scores``, and
    the reference's beams and re-rank that agree with it."""
    kary, k, max_len = 4, 2, 3
    beams = ref_switch.Beams([cids], [np.asarray(scores, np.float32)],
                             np.asarray([1.0]), route_gap=np.asarray([1.0]))
    docs = np.asarray([[[0, 1]]])
    rr = ref_serve.Reranked(docs, np.asarray([[[0.5, 0.25]]], np.float32),
                            [{0: 0.5, 1: 0.25}], [{0: 0.0, 1: 0.0}])
    from gdrbench.drivers.serve import as_served
    return as_served(beams, rr, kary, k, max_len), beams, rr


def test_a_router_tie_leaves_out_all_but_malformed():
    drv = harness.cell(harness.load_spec(REPO), CELL, REPO).driver
    cids = {(0, 1), (1, 2)}
    served, beams, rr = _answer([(0, 1), (1, 2)], [-1.0, -2.0])
    served["beam_scores"][0, 0] += 1.0            # a wrong score
    got, info = drv.numbers([served], [(beams, rr)], 4, [0.0], cids)
    assert got["beam_score_err"] == pytest.approx(1.0)
    beams.route_gap[0] = drv.ROUTE_TIE_GAP / 2    # a router tie
    got, info = drv.numbers([served], [(beams, rr)], 4, [0.0], cids)
    assert got["beam_score_err"] == 0 and got["route_tie_share"] == 1.0
    assert info["route_tied"] == 1 and got["malformed"] == 0
    served["valid"][0, 1] = False                 # a wrong beam count
    got, _ = drv.numbers([served], [(beams, rr)], 4, [0.0], cids)
    assert got["malformed"] == 1


@pytest.mark.cuda
def test_the_tf32_control_fails_on_the_card():
    """``control_switch.py`` at the cell's own size: the Switch reference in
    TF32 comes out not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gdrbench import control_switch
    cell = harness.cell(harness.load_spec(REPO), CELL, REPO)
    row = control_switch.control(cell, 101, torch.device("cuda:0"))
    assert not row["correct"], row
