"""The port's document tower (``gdr_tpu_torch/models/dual_encoder.py``) and
``embed_corpus`` against ``gdr_tpu``'s on the same bridged weights and the
same token arrays (some positions masked): f32 within 1e-5, bf16 within
atol 2e-2 (one bf16 step of an output near 2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdr_tpu.index.builder import embed_corpus as jax_embed_corpus
from gdr_tpu.models.dual_encoder import DocEncoder as JaxDocEncoder
from gdr_tpu.models.dual_encoder import tiny_doc_encoder as jax_tiny
from gdr_tpu_torch.convert import doc_encoder_params_from_flax
from gdr_tpu_torch.index.builder import embed_corpus
from gdr_tpu_torch.models.dual_encoder import (DocEncoder, DocEncoderConfig,
                                               init_doc_encoder,
                                               tiny_doc_encoder,
                                               tiny_doc_encoder_config)
from gdr_tpu_torch.parallel.mesh import make_mesh

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _tokens(n: int, length: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(n, length)).astype(np.int32)
    mask = np.ones_like(ids)
    lens = rng.integers(2, length + 1, size=n)
    mask[np.arange(length)[None] >= lens[:, None]] = 0
    ids[mask == 0] = 0
    return ids, mask


def _pair(jax_enc, seed: int = 0):
    """(flax params, the port's tower on the same weights)."""
    ids = np.zeros((2, 8), np.int32)
    params = jax_enc.init(jax.random.PRNGKey(seed), ids, np.ones_like(ids))
    cfg = DocEncoderConfig(vocab_size=jax_enc.vocab_size,
                           d_model=jax_enc.d_model,
                           num_layers=jax_enc.num_layers,
                           num_heads=jax_enc.num_heads, d_ff=jax_enc.d_ff,
                           max_position=jax_enc.max_position)
    tower = DocEncoder(cfg)
    tower.load_state_dict(doc_encoder_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, tower.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("seed,d_model", [(0, 32), (1, 48)])
def test_doc_tower_matches_gdr_tpu(dtype, seed, d_model):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jax_enc = dataclasses.replace(jax_tiny(d_model), dtype=jdt)
    params, tower = _pair(jax_enc, seed)
    ids, mask = _tokens(24, 20, jax_enc.vocab_size, seed)
    want = np.asarray(jax_enc.apply(params, ids, mask).astype(jnp.float32))
    with torch.no_grad():
        got = tower.to(dtype)(torch.as_tensor(ids).long(),
                              torch.as_tensor(mask))
    assert got.dtype == dtype and got.shape == (24, d_model)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dtype])


def test_bridge_maps_every_leaf_of_the_full_tower():
    enc = JaxDocEncoder(num_layers=1)            # BERT-base widths, one layer
    shapes = jax.eval_shape(lambda: enc.init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32),
        np.ones((1, 4), np.int32)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    tower = DocEncoder(dataclasses.replace(DocEncoderConfig(), num_layers=1))
    tower.load_state_dict(doc_encoder_params_from_flax(tree))   # strict
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2, 2, 2))}
    with pytest.raises(ValueError, match="no doc-tower counterpart"):
        doc_encoder_params_from_flax(tree)


def test_embed_corpus_matches_gdr_tpu_at_any_batch():
    jax_enc = jax_tiny()
    params, tower = _pair(jax_enc, 3)
    ids, mask = _tokens(23, 16, jax_enc.vocab_size, 3)
    want = jax_embed_corpus(jax_enc, params, ids, mask, batch_size=8)
    rows = [embed_corpus(tower, ids, mask, batch_size=b) for b in (4, 10)]
    for got in rows:
        assert got.dtype == np.float32 and got.shape == (23, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=1e-6)
    unit = embed_corpus(tower, ids, mask, batch_size=5, normalize=True)
    want_unit = jax_embed_corpus(jax_enc, params, ids, mask, batch_size=8,
                                 normalize=True)
    np.testing.assert_allclose(unit, want_unit, rtol=0, atol=1e-6)
    assert embed_corpus(tower, ids[:0], mask[:0]).shape == (0, 32)


def test_embed_corpus_raises_on_non_finite_output():
    tower = init_doc_encoder(tiny_doc_encoder(),
                             torch.Generator().manual_seed(0)).eval()
    ids, mask = _tokens(6, 12, 512)
    assert np.isfinite(embed_corpus(tower, ids, mask, batch_size=4)).all()
    with torch.no_grad():
        tower.tok_embed.weight[ids[4, 0]] = float("nan")
    with pytest.raises(ValueError, match="non-finite embeddings for 1 docs "
                                         r"\(first: \[4\]\)"):
        embed_corpus(tower, ids, mask, batch_size=4)


def test_embed_corpus_refuses_ids_outside_the_vocab():
    tower = tiny_doc_encoder().eval()
    ids, mask = _tokens(3, 8, 512)
    ids[1, 2] = 512
    with pytest.raises(ValueError, match="outside the doc encoder's vocab"):
        embed_corpus(tower, ids, mask)
    with pytest.raises(ValueError, match="positions"):
        tower(torch.zeros(1, 65, dtype=torch.long),
              torch.ones(1, 65, dtype=torch.long))
    # a mesh over a world of one embeds as one process
    ids[1, 2] = 5
    np.testing.assert_array_equal(
        embed_corpus(tower, ids, mask, batch_size=2, mesh=make_mesh()),
        embed_corpus(tower, ids, mask, batch_size=2))


def test_seeded_init_is_deterministic_and_scaled():
    a = init_doc_encoder(DocEncoder(tiny_doc_encoder_config()),
                         torch.Generator().manual_seed(5))
    b = init_doc_encoder(DocEncoder(tiny_doc_encoder_config()),
                         torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(a.embed_ln.weight, torch.ones(32))
    assert torch.equal(a.blocks[0].ff1.bias, torch.zeros(64))
    std = a.blocks[0].ff2.weight.std().item()       # N(0, 1/fan_in), fan 64
    assert 0.8 / 8 < std < 1.2 / 8
