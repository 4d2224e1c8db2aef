"""The port's trie helpers, index build and corpus expansion
(``gdr_tpu_torch/ops/trie.py``, ``index/builder.py``, ``index/expand.py``,
``index/io.py``) against ``gdr_tpu``'s on the same stores: trie arrays
exactly, node embeddings within 1e-6, and index files that either package
reads."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gdr_tpu.config import IndexConfig as JaxIndexConfig
from gdr_tpu.index import builder as jax_builder
from gdr_tpu.index.expand import expand_index as jax_expand_index
from gdr_tpu.index.io import load_index as jax_load_index
from gdr_tpu.index.io import save_index as jax_save_index
from gdr_tpu.models.dual_encoder import tiny_doc_encoder as jax_tiny
from gdr_tpu.ops import trie as jax_trie
from gdr_tpu_torch.config import IndexConfig
from gdr_tpu_torch.convert import doc_encoder_params_from_flax
from gdr_tpu_torch.index.builder import (build_index,
                                         build_index_from_embeddings)
from gdr_tpu_torch.index.expand import expand_index, expand_with_encoder
from gdr_tpu_torch.index.io import load_index, save_index
from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                               tiny_doc_encoder_config)
from gdr_tpu_torch.ops import trie
from torch_port_helpers import small_cid_map

STRUCTURE = ("children", "eos_allowed", "depth")
TRIE_FIELDS = STRUCTURE + ("doc_start", "doc_count", "doc_indices",
                           "cluster_of_node", "cluster_node_ids",
                           "cluster_docs", "cluster_doc_mask", "leaf_count")
CFG = dict(kary=4, leaf_cap=8, embedding_dim=16, max_docs_per_cluster=16)


def _unit(rng, n: int, d: int) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same_trie(got, want, emb_atol=1e-6):
    for f in TRIE_FIELDS:
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
    np.testing.assert_allclose(got.node_embedding, want.node_embedding,
                               rtol=0, atol=emb_atol)


def _same_index(got, want):
    _same_trie(got.trie, want.trie)
    np.testing.assert_array_equal(got.store, want.store)
    assert got.paths == want.paths and got.cid_of_doc == want.cid_of_doc


@pytest.fixture(scope="module")
def world():
    cid_to_docs = small_cid_map(docs_per=3)
    n = sum(len(v) for v in cid_to_docs.values())
    emb = _unit(np.random.default_rng(0), n, 12)
    return cid_to_docs, emb


def test_trie_helpers_match_gdr_tpu(world):
    cid_to_docs, emb = world
    got = trie.build_trie(cid_to_docs, 4, 8, doc_embeddings=emb)
    want = jax_trie.build_trie(cid_to_docs, 4, 8, doc_embeddings=emb)
    _same_trie(got, want)
    assert got.max_docs_per_cluster == want.max_docs_per_cluster == 8
    assert got.id_mapping() == want.id_mapping()
    for node in range(got.num_nodes):
        assert got.cid_of_node(node) == want.cid_of_node(node)
    assert got.cids_of_nodes(got.cluster_node_ids) == \
        want.cids_of_nodes(want.cluster_node_ids)
    for cid in ("0-1-1", "3-3", "3", "2-3-1", ""):
        digits = [int(c) for c in cid.split("-")] if cid else []
        assert got.node_of_path(digits) == want.node_of_path(digits)
        assert got.docs_of_cid(cid) == want.docs_of_cid(cid)
    rng = np.random.default_rng(1)
    for q in _unit(rng, 8, 12):
        assert trie.tree_match(got, q) == jax_trie.tree_match(want, q)


def test_parent_map_is_memoised_until_replace(world):
    t = trie.build_trie(world[0], 4)
    first = t.parent_arrays()
    assert all(a is b for a, b in zip(t.parent_arrays(), first))
    fresh = dataclasses.replace(t, leaf_count=None)
    assert fresh.parent_arrays()[0] is not first[0]
    for a, b in zip(fresh.parent_arrays(), first):
        np.testing.assert_array_equal(a, b)


def test_compute_node_embeddings_matches_gdr_tpu(world):
    cid_to_docs, emb = world
    got = trie.compute_node_embeddings(trie.build_trie(cid_to_docs, 4), emb)
    want = jax_trie.compute_node_embeddings(
        jax_trie.build_trie(cid_to_docs, 4), emb)
    _same_trie(got, want)
    # a node's embedding is the mean of the documents below it
    root_docs = np.concatenate([v for v in cid_to_docs.values()])
    np.testing.assert_allclose(got.node_embedding[0],
                               emb[root_docs].mean(0), atol=1e-6)


@pytest.mark.parametrize("n_new,cap", [(40, 4), (5, 32)])
def test_insert_docs_matches_gdr_tpu(world, n_new, cap):
    cid_to_docs, emb = world
    base = trie.build_trie(cid_to_docs, 4, cap, doc_embeddings=emb)
    jbase = jax_trie.build_trie(cid_to_docs, 4, cap, doc_embeddings=emb)
    new = _unit(np.random.default_rng(n_new), n_new, 12)
    got, rows = trie.insert_docs(base, new, len(emb))
    want, wrows = jax_trie.insert_docs(jbase, new, len(emb))
    np.testing.assert_array_equal(rows, wrows)
    _same_trie(got, want)
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(got, f), getattr(base, f))
    np.testing.assert_array_equal(got.node_embedding, base.node_embedding)
    assert got.max_docs_per_cluster == max(cap, int(got.doc_count.max()))
    with pytest.raises(ValueError, match="node embeddings"):
        trie.insert_docs(trie.build_trie(cid_to_docs, 4), new, len(emb))


@pytest.mark.parametrize("n,threshold", [(300, 1000), (700, 0)])
def test_build_index_from_embeddings_matches_gdr_tpu(n, threshold):
    store = _unit(np.random.default_rng(n), n, 16)
    cfg = dict(CFG, minibatch_threshold=threshold)
    got = build_index_from_embeddings(store, IndexConfig(**cfg),
                                      device="cpu")
    want = jax_builder.build_index_from_embeddings(store,
                                                   JaxIndexConfig(**cfg))
    _same_index(got, want)
    assert got.trie.num_clusters > 8
    # a store tensor on the device gives the same index
    again = build_index_from_embeddings(torch.as_tensor(store),
                                        IndexConfig(**cfg))
    _same_index(again, want)
    with pytest.raises(ValueError, match="embedding_dim"):
        build_index_from_embeddings(store[:, :8], IndexConfig(**cfg))


@pytest.fixture(scope="module")
def built():
    store = _unit(np.random.default_rng(5), 400, 16)
    got = build_index_from_embeddings(store, IndexConfig(**CFG), "cpu")
    want = jax_builder.build_index_from_embeddings(store,
                                                   JaxIndexConfig(**CFG))
    return got, want


@pytest.mark.parametrize("n_new", [1, 60])
def test_expand_index_matches_gdr_tpu(built, n_new):
    got, want = built
    new = _unit(np.random.default_rng(n_new), n_new, 16)
    big = expand_index(got, new)
    jbig = jax_expand_index(want, new)
    _same_index(big, jbig)
    assert len(big.paths) == len(big.store) == 400 + n_new
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(big.trie, f),
                                      getattr(got.trie, f))
    assert big.cid_of_doc[:400] == got.cid_of_doc
    # an index saved without node embeddings gets them computed first
    bare = dataclasses.replace(got, trie=dataclasses.replace(
        got.trie, node_embedding=None, leaf_count=None))
    _same_index(expand_index(bare, new), jbig)


def test_index_files_round_trip_across_packages(built, tmp_path):
    got, want = built
    big = expand_index(got, _unit(np.random.default_rng(9), 20, 16))
    save_index(str(tmp_path / "port.npz"), big)
    back = jax_load_index(str(tmp_path / "port.npz"))
    _same_index(back, big)
    jax_save_index(str(tmp_path / "ref.npz"), jax_expand_index(
        want, _unit(np.random.default_rng(9), 20, 16)))
    _same_index(load_index(str(tmp_path / "ref.npz")), back)


def _as_jax_index(index):
    """The port's Index as gdr_tpu's (same arrays)."""
    return jax_builder.Index(store=index.store, trie=jax_trie.TrieTensors(
        **{f.name: getattr(index.trie, f.name)
           for f in dataclasses.fields(jax_trie.TrieTensors)}),
        paths=index.paths, cid_of_doc=index.cid_of_doc)


def test_build_index_and_expand_with_encoder_match_gdr_tpu():
    # the tiny tower on gdr_tpu's init, bridged; the k-means of both
    # packages over the port's store
    jax_enc = jax_tiny(16)
    rng = np.random.default_rng(2)
    ids = rng.integers(2, 512, size=(90, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[::3, 7:] = 0
    params = jax_enc.init(jax.random.PRNGKey(0), ids[:2], mask[:2])
    tower = DocEncoder(tiny_doc_encoder_config(16))
    tower.load_state_dict(doc_encoder_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tower.eval()
    got = build_index(tower, ids, mask, IndexConfig(**CFG), batch_size=32)
    jstore = jax_builder.embed_corpus(jax_enc, params, ids, mask, 32)
    np.testing.assert_allclose(got.store, jstore, rtol=0, atol=1e-5)
    _same_index(got, jax_builder.build_index_from_embeddings(
        got.store, JaxIndexConfig(**CFG)))
    big = expand_with_encoder(got, tower, ids[:10], mask[:10], batch_size=4)
    _same_index(big, jax_expand_index(_as_jax_index(got), big.store[90:]))

