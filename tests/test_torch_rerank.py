"""The port's re-rank (ops/rerank.py, kernels/rerank.py) and its host
copies (trie, packed layout) against the JAX package, on every store
layout (plain, packed, and both as int8), with one query row per query or
one per beam, against the JAX functions' XLA paths and their Pallas
kernels in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdr_tpu.ops import packed_store as jps
from gdr_tpu.ops import quantize as jq
from gdr_tpu.ops import rerank as jrr
from gdr_tpu.ops.pallas.rerank_kernel import (packed_scores_pallas,
                                              rerank_scores_pallas)
from gdr_tpu.ops.trie import build_trie as jax_build_trie
from gdr_tpu_torch import kernels
from gdr_tpu_torch.kernels import rerank as kr
from gdr_tpu_torch.ops import packed_store as tps
from gdr_tpu_torch.ops import quantize as tq
from gdr_tpu_torch.ops import rerank as trr
from gdr_tpu_torch.ops.trie import build_trie
from torch_port_helpers import small_cid_map

D = 16
ALPHAS = np.asarray([0.0, 0.5, 2.0], np.float32)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(2)
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, 4, max_docs_per_cluster=4)
    jtrie = jax_build_trie(cid_to_docs, 4, max_docs_per_cluster=4,
                           use_native=False)
    rng = np.random.default_rng(0)
    n = sum(len(v) for v in cid_to_docs.values())
    store = rng.normal(size=(n, D)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    b, k = 2, 6
    nodes = rng.choice(trie.cluster_node_ids, size=(b, k)).astype(np.int32)
    valid = np.ones((b, k), bool)
    valid[1, 4:] = False
    beam_scores = rng.normal(size=(b, k)).astype(np.float32)
    q = rng.normal(size=(b, D)).astype(np.float32)
    return trie, jtrie, store, nodes, valid, beam_scores, q


def test_trie_arrays_equal_jax(world):
    trie, jtrie = world[:2]
    for name in ("children", "eos_allowed", "depth", "doc_start", "doc_count",
                 "doc_indices", "cluster_of_node", "cluster_node_ids",
                 "cluster_docs", "cluster_doc_mask"):
        np.testing.assert_array_equal(getattr(trie, name),
                                      getattr(jtrie, name), err_msg=name)


def test_pack_layout_and_rows_equal_jax(world):
    trie, jtrie, store = world[:3]
    got = tps.pack_layout(trie)
    want = jps.pack_layout(jtrie)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    rows = tps.pack_rows(torch.tensor(store), torch.tensor(got[2]))
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jps.pack_rows(store, want[2])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_scores_plain_matches_pallas(world, dtype):
    trie, _, store = world[:3]
    starts, _, row_to_doc, cap = tps.pack_layout(trie)
    rows = tps.pack_rows(torch.tensor(store), torch.tensor(row_to_doc))
    rng = np.random.default_rng(1)
    r = 12
    beam_starts = rng.choice(starts, size=r).astype(np.int32)
    q = rng.normal(size=(r, D)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = packed_scores_pallas(jnp.asarray(rows.numpy(), jdt),
                                jnp.asarray(beam_starts),
                                jnp.asarray(q, jdt), cap, interpret=True)
    kernels.reset_launch_counts()
    got = kr.packed_scores(rows.to(getattr(torch, dtype)),
                           torch.tensor(beam_starts),
                           torch.tensor(q).to(getattr(torch, dtype)), cap)
    assert kernels.launch_counts()["packed_scores"] == 0        # plain version on the cpu
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _valid_equal(got, want):
    dv = np.asarray(want.doc_valid)
    np.testing.assert_array_equal(got.doc_valid.numpy(), dv)
    np.testing.assert_array_equal(got.doc_ids.numpy()[dv],
                                  np.asarray(want.doc_ids)[dv])
    np.testing.assert_allclose(got.scores.numpy()[dv],
                               np.asarray(want.scores)[dv], atol=1e-5)
    np.testing.assert_allclose(got.cluster_probs.numpy(),
                               np.asarray(want.cluster_probs), atol=1e-6)


@pytest.mark.parametrize("top_r", [5, 40])      # 40 > the 24 candidates
def test_rerank_matches_jax(world, top_r):
    trie, _, store, nodes, valid, beam_scores, q = world
    t = lambda a: torch.tensor(np.asarray(a))
    want = jrr.rerank(jnp.asarray(store), jnp.asarray(q), jnp.asarray(nodes),
                      jnp.asarray(beam_scores), jnp.asarray(valid),
                      jnp.asarray(trie.cluster_of_node),
                      jnp.asarray(trie.cluster_docs),
                      jnp.asarray(trie.cluster_doc_mask), jnp.asarray(ALPHAS),
                      top_r=top_r)
    got = trr.rerank(t(store), t(q), t(nodes), t(beam_scores), t(valid),
                     t(trie.cluster_of_node), t(trie.cluster_docs),
                     t(trie.cluster_doc_mask), t(ALPHAS), top_r=top_r)
    assert got.doc_ids.shape == (len(ALPHAS), 2, top_r)
    _valid_equal(got, want)


@pytest.mark.parametrize("top_r", [5, 40])
def test_rerank_packed_matches_jax(world, top_r):
    trie, _, store, nodes, valid, beam_scores, q = world
    t = lambda a: torch.tensor(np.asarray(a))
    starts, counts, row_to_doc, cap = tps.pack_layout(trie)
    rows = tps.pack_rows(t(store), t(row_to_doc))
    want = jrr.rerank_packed(jnp.asarray(rows.numpy()), jnp.asarray(starts),
                             jnp.asarray(counts), jnp.asarray(row_to_doc), cap,
                             jnp.asarray(q), jnp.asarray(nodes),
                             jnp.asarray(beam_scores), jnp.asarray(valid),
                             jnp.asarray(trie.cluster_of_node),
                             jnp.asarray(ALPHAS), top_r=top_r)
    got = trr.rerank_packed(rows, t(starts), t(counts), t(row_to_doc), cap,
                            t(q), t(nodes), t(beam_scores), t(valid),
                            t(trie.cluster_of_node), t(ALPHAS), top_r=top_r)
    _valid_equal(got, want)


def test_padded_top_k_pads(world):
    s = torch.tensor([[0.3, 0.9, 0.1]])
    top, pay = trr.padded_top_k(s, torch.tensor([[7, 8, 9]]), 5)
    np.testing.assert_allclose(top.numpy(), [[0.9, 0.3, 0.1, -1e9, -1e9]])
    np.testing.assert_array_equal(pay.numpy(), [[8, 7, 9, 0, 0]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,cap", [(13, 6), (8, 9)])   # ragged R; cap % 4 != 0
def test_rerank_scores_plain_matches_pallas(world, dtype, r, cap):
    store = world[2]
    rng = np.random.default_rng(r + cap)
    docs = rng.integers(0, len(store), size=(r, cap)).astype(np.int32)
    mask = rng.random((r, cap)) < 0.7
    mask[0] = False                                  # a fully masked beam
    q = rng.normal(size=(r, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = rerank_scores_pallas(jnp.asarray(store, jdt), jnp.asarray(docs),
                                jnp.asarray(q), jnp.asarray(mask), chunk=4,
                                interpret=True)
    kernels.reset_launch_counts()
    got = kr.rerank_scores(torch.tensor(store).to(tdt), torch.tensor(docs),
                           torch.tensor(q), torch.tensor(mask))
    assert kernels.launch_counts()["rerank_scores"] == 0        # plain version on the cpu
    assert got.shape == (r, cap) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _query(world, q_ndim):
    """[B, d] or [B, K, d] query rows, as numpy."""
    b, k = world[3].shape
    if q_ndim == 2:
        return world[6]
    return np.random.default_rng(9).normal(size=(b, k, D)).astype(np.float32)


@pytest.mark.parametrize("q_ndim", [2, 3], ids=["q_bd", "q_bkd"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_rerank_layouts_match_jax(world, int8, use_pallas, q_ndim):
    trie, _, store, nodes, valid, beam_scores, _ = world
    q = _query(world, q_ndim)
    t = lambda a: torch.tensor(np.asarray(a))
    jstore = jq.quantize_store(store) if int8 else jnp.asarray(store)
    tstore = tq.quantize_store(t(store)) if int8 else t(store)
    want = jrr.rerank(jstore, jnp.asarray(q), jnp.asarray(nodes),
                      jnp.asarray(beam_scores), jnp.asarray(valid),
                      jnp.asarray(trie.cluster_of_node),
                      jnp.asarray(trie.cluster_docs),
                      jnp.asarray(trie.cluster_doc_mask), jnp.asarray(ALPHAS),
                      top_r=10, use_pallas=use_pallas,
                      pallas_interpret=use_pallas)
    got = trr.rerank(tstore, t(q), t(nodes), t(beam_scores), t(valid),
                     t(trie.cluster_of_node), t(trie.cluster_docs),
                     t(trie.cluster_doc_mask), t(ALPHAS), top_r=10)
    _valid_equal(got, want)


@pytest.mark.parametrize("q_ndim", [2, 3], ids=["q_bd", "q_bkd"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_rerank_packed_layouts_match_jax(world, int8, use_pallas, q_ndim):
    trie, _, store, nodes, valid, beam_scores, _ = world
    q = _query(world, q_ndim)
    t = lambda a: torch.tensor(np.asarray(a))
    starts, counts, row_to_doc, cap = tps.pack_layout(
        trie, align=32 if int8 else 8)
    if int8:
        trows = tq.pack_quantized_rows(t(store), t(row_to_doc))
        jrows = jq.pack_quantized_rows(store, jnp.asarray(row_to_doc))
    else:
        trows = tps.pack_rows(t(store), t(row_to_doc))
        jrows = jnp.asarray(trows.numpy())
    want = jrr.rerank_packed(jrows, jnp.asarray(starts), jnp.asarray(counts),
                             jnp.asarray(row_to_doc), cap, jnp.asarray(q),
                             jnp.asarray(nodes), jnp.asarray(beam_scores),
                             jnp.asarray(valid),
                             jnp.asarray(trie.cluster_of_node),
                             jnp.asarray(ALPHAS), top_r=10,
                             use_pallas=use_pallas,
                             pallas_interpret=use_pallas)
    got = trr.rerank_packed(trows, t(starts), t(counts), t(row_to_doc), cap,
                            t(q), t(nodes), t(beam_scores), t(valid),
                            t(trie.cluster_of_node), t(ALPHAS), top_r=10)
    _valid_equal(got, want)
