"""The port's host data path against ``gdr_tpu``'s, bit for bit: train
sets (queries and CID labels, with the label cutoff), the doc / aug
pseudo-query sources and their mix, ``BatchIterator``'s batches with
same-cluster candidates and hard-negative labels (pooled and random),
``doc_label_arrays``, ``cluster_docs_lookup``, BM25 and random negatives,
and the weight-distillation targets ``prefix_node_embeddings``."""

import numpy as np
import pytest

from gdr_tpu.config import DataConfig as JaxDataConfig
from gdr_tpu.config import ModelConfig as JaxModelConfig
from gdr_tpu.data import dataset as jd
from gdr_tpu.data import negatives as jn
from gdr_tpu.data.tokenize import HashTokenizer as JaxTokenizer
from gdr_tpu.ops.trie import build_trie as jax_build_trie
from gdr_tpu.ops.trie import prefix_node_embeddings as jax_prefix
from gdr_tpu_torch.config import DataConfig, ModelConfig
from gdr_tpu_torch.data import dataset as td
from gdr_tpu_torch.data import negatives as tn
from gdr_tpu_torch.data.tokenize import HashTokenizer
from gdr_tpu_torch.ops.trie import build_trie, prefix_node_embeddings
from torch_port_helpers import small_cid_map

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda "
         "mu nu xi omicron pi rho sigma tau upsilon phi chi psi").split()
MODEL = dict(kary=4, max_output_length=5, vocab_size=128)


def _world(seed=0):
    cid_to_docs = small_cid_map()
    n = sum(len(v) for v in cid_to_docs.values())
    paths = [None] * n
    for cid, docs in cid_to_docs.items():
        for d in docs:
            paths[d] = [int(c) for c in cid.split("-")]
    rng = np.random.default_rng(seed)
    docs = [" ".join(rng.choice(WORDS, int(rng.integers(3, 40))))
            for _ in range(n)]
    queries = [" ".join(rng.choice(WORDS, 4)) for _ in range(30)]
    positives = [[int(d)] for d in rng.integers(0, n, 30)]
    return cid_to_docs, paths, docs, queries, positives


def _same_sets(a, b):
    for f in ("input_ids", "attn_mask", "labels", "label_mask", "pos_idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.source == b.source and a.neg_pool == b.neg_pool


@pytest.mark.parametrize("cutoff", [False, True])
def test_train_sets_and_sources(cutoff):
    _, paths, docs, queries, positives = _world()
    pos = [p[0] for p in positives]
    mine = td.build_train_set(queries, pos, paths, HashTokenizer(128),
                              ModelConfig(**MODEL), 12,
                              label_length_cutoff=cutoff)
    ref = jd.build_train_set(queries, pos, paths, JaxTokenizer(128),
                             JaxModelConfig(**MODEL), 12,
                             label_length_cutoff=cutoff)
    _same_sets(mine, ref)
    dq = td.build_doc_query_sets(docs, paths, HashTokenizer(128),
                                 ModelConfig(**MODEL),
                                 DataConfig(max_input_length=12, doc_length=6),
                                 rng=np.random.default_rng(3))
    jq = jd.build_doc_query_sets(docs, paths, JaxTokenizer(128),
                                 JaxModelConfig(**MODEL),
                                 JaxDataConfig(max_input_length=12,
                                               doc_length=6),
                                 rng=np.random.default_rng(3))
    _same_sets(td.mix_sources("gtq_doc_aug", gtq=mine, **dq),
               jd.mix_sources("gtq_doc_aug", gtq=ref, **jq))
    toks = np.random.default_rng(4).integers(2, 128, (5, 12)).astype(np.int32)
    _same_sets(td.build_train_set_from_tokens(toks, np.ones_like(toks),
                                              pos[:5], paths,
                                              ModelConfig(**MODEL)),
               jd.build_train_set_from_tokens(toks, np.ones_like(toks),
                                              pos[:5], paths,
                                              JaxModelConfig(**MODEL)))


@pytest.mark.parametrize("negatives", ["none", "pooled", "random"])
def test_batch_iterator_bit_equal(negatives):
    cid_to_docs, paths, _, queries, positives = _world(1)
    cid_of = ["-".join(map(str, p)) for p in paths]
    lookup = td.cluster_docs_lookup(cid_of)
    assert lookup == jd.cluster_docs_lookup(cid_of)
    sets = [m.build_train_set(queries, [p[0] for p in positives], paths,
                              tok(128), cfg(**MODEL), 12)
            for m, tok, cfg in ((td, HashTokenizer, ModelConfig),
                                (jd, JaxTokenizer, JaxModelConfig))]
    kw = [{}, {}]
    if negatives != "none":
        dl, dm = td.doc_label_arrays(paths, ModelConfig(**MODEL))
        jl_, jm_ = jd.doc_label_arrays(paths, JaxModelConfig(**MODEL))
        np.testing.assert_array_equal(dl, jl_)
        np.testing.assert_array_equal(dm, jm_)
        kw = [dict(sample_neg_num=2, doc_labels=dl, doc_label_mask=dm),
              dict(sample_neg_num=2, doc_labels=jl_, doc_label_mask=jm_)]
        if negatives == "pooled":
            pools = [list(range(i, i + 6)) for i in range(len(queries))]
            pools[3] = []                       # a row without a pool
            for s in sets:
                s.neg_pool = pools
    batches = [list(m.BatchIterator(s, lookup, 4, 3, seed=7, **k))
               for m, s, k in zip((td, jd), sets, kw)]
    assert len(batches[0]) == len(batches[1]) == len(queries) // 4
    for a, b in zip(*batches):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)


def test_negatives_bit_equal():
    _, _, docs, queries, positives = _world(2)
    assert tn.bm25_negatives(queries, positives, docs, k=7) == \
        jn.bm25_negatives(queries, positives, docs, k=7)
    assert tn.random_negatives(len(queries), len(docs), positives, k=9,
                               seed=5) == \
        jn.random_negatives(len(queries), len(docs), positives, k=9, seed=5)


def test_prefix_node_embeddings_bit_equal():
    cid_to_docs, paths, _, _, _ = _world(3)
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(len(paths), 8)).astype(np.float32)
    mine = build_trie(cid_to_docs, 4, doc_embeddings=emb)
    ref = jax_build_trie(cid_to_docs, 4, doc_embeddings=emb, use_native=False)
    labels, lmask = td.doc_label_arrays(paths[:20], ModelConfig(**MODEL))
    labels[3, 1] = 4 * 1 + 2 + 3                 # a prefix off the trie
    for got, want in zip(prefix_node_embeddings(mine, labels, lmask, 4),
                         jax_prefix(ref, labels, lmask, 4)):
        np.testing.assert_array_equal(got, want)
