"""The weight bridge: every leaf of the JAX parameter tree lands in exactly
one port parameter, in the right layout; a missing or extra key raises.
The inverse bridge gives the tree back bit for bit, and ``save_params_npz``
writes the ``params.npz`` that ``load_params_npz`` reads."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from gdr_tpu.config import tiny_config
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu.models.gdr import init_params
from gdr_tpu_torch.config import tiny_config as port_tiny_config
from gdr_tpu_torch.convert import (load_params_npz, params_from_flax,
                                   params_to_flax, save_params_npz)
from gdr_tpu_torch.models.gdr import GenerativeRetriever

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tree():
    torch.set_num_threads(2)
    model = JaxRetriever(tiny_config().model)       # d 32 → query_proj 16
    params = init_params(model, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _port():
    return GenerativeRetriever(port_tiny_config().model)


def _load(sd):
    model = _port()
    model.load_state_dict(sd)          # strict: a missing or extra key raises
    return model


def test_every_leaf_consumed_and_every_parameter_filled(tree):
    sd = params_from_flax(tree)
    model = _load(sd)
    assert set(sd) == set(model.state_dict())
    n_flax = sum(leaf.size for _, leaf in _leaves(tree))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_flax == n_port


def test_layouts(tree):
    p = tree["params"]
    model = _load(params_from_flax(tree))
    att = p["decoder"]["block_0"]["self_attn"]
    want = np.concatenate([att["q"]["kernel"].T, att["k"]["kernel"].T,
                           att["v"]["kernel"].T], axis=0)
    blk = model.decoder.blocks[0]
    np.testing.assert_array_equal(blk.self_attn.qkv.weight.detach().numpy(),
                                  want)
    np.testing.assert_array_equal(blk.ff.wi.weight.detach().numpy(),
                                  p["decoder"]["block_0"]["ff"]["wi"]["kernel"].T)
    np.testing.assert_array_equal(model.pawa.u.detach().numpy(),
                                  p["pawa"]["u"])
    np.testing.assert_array_equal(
        model.pawa.layers[0].ln2.bias.detach().numpy(),
        p["pawa"]["layer_0"]["ln2"]["bias"])
    np.testing.assert_array_equal(model.query_proj.weight.detach().numpy(),
                                  p["query_proj"]["kernel"].T)


def _drop(tree, *path):
    out = jax.tree_util.tree_map(lambda x: x, tree)
    node = out
    for k in path[:-1]:
        node = node[k]
    del node[path[-1]]
    return out


def test_missing_norm_scale_raises(tree):
    broken = _drop(tree, "params", "decoder", "block_0", "ln2", "scale")
    with pytest.raises(RuntimeError, match="Missing key"):
        _load(params_from_flax(broken))


def test_incomplete_qkv_raises(tree):
    broken = _drop(tree, "params", "encoder", "block_1", "attn", "v")
    with pytest.raises(ValueError, match="needs q, k and v"):
        params_from_flax(broken)


def test_extra_module_raises(tree):
    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["params"]["denoise_disc"] = {"kernel": np.zeros((32, 2), np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        _load(params_from_flax(extra))


def test_unmappable_leaf_raises(tree):
    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["params"]["encoder"]["mystery"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no port counterpart"):
        params_from_flax(extra)


@pytest.mark.parametrize("overrides", [dict(concate_fusion=True),
                                       dict(adaptor_efficient=False)],
                         ids=["concate-fusion", "slow-pawa"])
def test_optional_heads_load_strictly(overrides):
    # the fusion layer's kernel and bias, the slow PAWA head's own
    # embedding and its U2
    jcfg = dataclasses.replace(tiny_config().model, **overrides)
    tree = jax.tree_util.tree_map(
        np.asarray, init_params(JaxRetriever(jcfg), jax.random.PRNGKey(1)))
    sd = params_from_flax(tree)
    model = GenerativeRetriever(dataclasses.replace(
        port_tiny_config().model, **overrides))
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())
    assert sum(leaf.size for _, leaf in _leaves(tree)) == sum(
        p.numel() for p in model.parameters())
    p = tree["params"]
    if "concate_fusion" in overrides:
        pairs = [(model.fusion.weight, p["fusion"]["kernel"].T),
                 (model.fusion.bias, p["fusion"]["bias"])]
    else:
        pairs = [(model.pawa.embed.weight, p["pawa"]["embed"]["embedding"]),
                 (model.pawa.u2, p["pawa"]["u2"])]
    for got, want in pairs:
        np.testing.assert_array_equal(got.detach().numpy(), want)


def test_export_tool_round_trip(tree, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "export_gdr_tpu_params", ROOT / "tools" / "export_gdr_tpu_params.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    path = str(tmp_path / "params.npz")
    assert tool.export(tree, path) == len(_leaves(tree))
    got, want = load_params_npz(path), params_from_flax(tree)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("overrides", [
    {}, dict(adaptor_efficient=False),
    dict(denoising=True, tie_decode_embedding=False, concate_fusion=True)],
    ids=["default", "slow-pawa", "denoise-untied-fusion"])
def test_inverse_bridge_round_trip_is_bit_equal(overrides, tmp_path):
    jcfg = dataclasses.replace(tiny_config().model, **overrides)
    tree = jax.tree_util.tree_map(
        np.asarray, init_params(JaxRetriever(jcfg), jax.random.PRNGKey(2)))
    sd = params_from_flax(tree)
    back = params_to_flax(sd)
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    path = str(tmp_path / "params.npz")
    assert save_params_npz(path, sd) == len(want)
    for k, v in load_params_npz(path).items():
        assert torch.equal(v, sd[k]), k


def _mode_tree(mode: str):
    """The tree gdr_tpu's ``mode`` keeps, from its own init, with the
    port's module of the same configuration."""
    from gdr_tpu.models import ensemble as jens
    from gdr_tpu.models import hierarchic as jh
    from gdr_tpu.models.classifier import EncoderClassifier as JaxClassifier
    from gdr_tpu.models.seq2seq import Seq2SeqLM as JaxSeq2Seq
    from gdr_tpu_torch.models.classifier import EncoderClassifier
    from gdr_tpu_torch.models.ensemble import Ensemble
    from gdr_tpu_torch.models.hierarchic import Hierarchic
    from gdr_tpu_torch.models.seq2seq import Seq2SeqLM

    jcfg, cfg = tiny_config().model, port_tiny_config().model
    key = jax.random.PRNGKey(3)
    ids = np.ones((2, 6), np.int32)
    if mode == "ensemble":
        enc, dec = jens.init_ensemble(JaxRetriever(jcfg), key, 2)
        return {"enc": enc, "dec": dec}, Ensemble(cfg, 2)
    if mode == "hierarchic":
        base, dec = jh.init_hierarchic(JaxRetriever(jcfg), key, 3)
        return {"base": base, "dec": dec}, Hierarchic(cfg, 3)
    if mode == "softmax":
        return (JaxClassifier(jcfg, num_cls=7).init(key, ids, ids),
                EncoderClassifier(cfg, 7))
    return (JaxSeq2Seq(jcfg).init(key, ids, ids, ids, ids), Seq2SeqLM(cfg))


@pytest.mark.parametrize("mode", ["ensemble", "hierarchic", "softmax",
                                  "seq2seq"])
def test_export_tool_writes_the_modes_trees(mode, tmp_path):
    """A secondary mode's flax msgpack → ``.npz`` → the port's module
    through its bridge, every leaf bit for bit."""
    from flax import serialization

    from gdr_tpu_torch import convert

    spec = importlib.util.spec_from_file_location(
        "export_gdr_tpu_params", ROOT / "tools" / "export_gdr_tpu_params.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jtree, module = _mode_tree(mode)
    src = tmp_path / f"{mode}.msgpack"
    src.write_bytes(serialization.to_bytes(jtree))
    out = str(tmp_path / f"{mode}.npz")
    assert tool.export_mode(mode, str(src), out) == len(_leaves(jtree))
    bridge = {"ensemble": convert.ensemble_from_flax,
              "hierarchic": convert.hierarchic_from_flax}.get(
                  mode, convert.params_from_flax)
    module.load_state_dict(bridge(convert.load_tree_npz(out)))
    back = {"ensemble": convert.ensemble_to_flax,
            "hierarchic": convert.hierarchic_to_flax}.get(
                mode, lambda m: convert.params_to_flax(m.state_dict()))(module)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jtree)))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
