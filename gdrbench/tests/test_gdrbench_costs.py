"""The frozen cost arithmetic reproduces PERF.md's worked counts, and the
weight list is the port's."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from conftest import REPO
from gdrbench import costs
from gdrbench.weights import make_weights, param_shapes

BASE = json.loads((REPO / "gdrbench" / "configs" / "gdr-t5-base-f32.json")
                  .read_text())["model"]


def test_decoder_row1_at_3200_rows():
    flops, f32 = costs.decoder_cost("self_attn_sublayer", 3200, 3, 4, 4)
    _, bf16 = costs.decoder_cost("self_attn_sublayer", 3200, 3, 4, 2)
    assert round(flops / 1e9, 1) == 15.1
    assert round(f32 / 1e6, 1) == 107.7
    assert round(bf16 / 1e6, 1) == 53.9


def test_train_step_bound():
    flops, nbytes = costs.train_step_cost(BASE, 128, 40, 376_102_272)
    ms = (flops / costs.H100_BF16_FLOPS + nbytes / costs.H100_BYTES) * 1e3
    assert round(ms, 3) == 6.763


@pytest.mark.parametrize("name,ms", [("self_attn_sublayer", 3.149),
                                     ("cross_attn_sublayer", 1.666),
                                     ("ffn_sublayer", 6.281)])
def test_f32_sublayer_bound_per_retrieve(name, ms):
    total = sum(costs.bound_s(*costs.decoder_cost(n, r, p, l, 4),
                              costs.H100_F32_FLOPS)
                for n, r, p, l in costs.decoder_calls(BASE, 32, 100, 4, 40)
                if n == name)
    assert total * 1e3 == pytest.approx(ms, abs=0.005)


def test_retrieve_steps_and_flops():
    assert costs.beam_steps(32, 100, 30, 4) == [(32, 0), (992, 1),
                                                (3200, 2), (3200, 3)]
    assert len(costs.decoder_calls(BASE, 32, 100, 4, 40)) == 72
    b32 = costs.retrieve_flops(BASE, 32, 100, 4, 40, 30.0)
    b1 = costs.retrieve_flops(BASE, 1, 100, 4, 40, 30.0)
    assert 1.0e12 < b32 < 2.0e12 and b1 < b32 / 20


@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_weights_are_the_ports_leaves(preset):
    from gdr_tpu_torch.config import ModelConfig, tiny_config
    from gdr_tpu_torch.models.gdr import GenerativeRetriever
    cfg = (tiny_config().model if preset == "tiny"
           else ModelConfig().scaled("base"))
    with torch.device("meta"):
        model = GenerativeRetriever(cfg)
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert param_shapes(dataclasses.asdict(cfg)) == want
    if preset == "tiny":
        w = make_weights(dataclasses.asdict(cfg), 2**35, "cpu")
        again = make_weights(dataclasses.asdict(cfg), 2**35, "cpu")
        assert all(torch.equal(w[n], again[n]) for n in w)
        assert float(w["shared.weight"].std()) == pytest.approx(1.0, rel=0.2)
