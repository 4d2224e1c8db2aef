"""Corpus expansion without retraining, mirroring ``gdr_tpu/index/expand.py``.

New documents are embedded, each joins the cluster whose node embedding has
the largest dot with it, and is appended to that cluster's doc list (the
reference's ``tree_embedding_insert``).  The generative model is untouched:
the trie's structure (``children``, ``eos_allowed``, ``depth``), and with it
the CID language the model memorised, does not change.  Only the doc tables
and the store grow.
"""

from __future__ import annotations

import numpy as np

from gdr_tpu_torch.index.builder import embed_corpus
from gdr_tpu_torch.index.io import Index
from gdr_tpu_torch.models.dual_encoder import DocEncoder
from gdr_tpu_torch.ops.trie import compute_node_embeddings, insert_docs


def expand_index(index: Index, new_doc_embeddings: np.ndarray) -> Index:
    """A new Index covering the enlarged corpus; new docs take ids from
    the old store's size on."""
    trie = index.trie
    if trie.node_embedding is None:
        trie = compute_node_embeddings(trie, index.store)
    first_new = index.store.shape[0]
    new_trie, rows = insert_docs(trie, new_doc_embeddings, first_new)
    store = np.concatenate([index.store,
                            np.asarray(new_doc_embeddings, np.float32)])
    cluster_cids = trie.cids_of_nodes(trie.cluster_node_ids)
    new_cids = [cluster_cids[int(r)] for r in rows]
    paths = index.paths + [[int(c) for c in cid.split("-")] for cid in new_cids]
    return Index(store=store, trie=new_trie, paths=paths,
                 cid_of_doc=index.cid_of_doc + new_cids)


def expand_with_encoder(index: Index, doc_encoder: DocEncoder,
                        token_ids: np.ndarray, masks: np.ndarray,
                        batch_size: int = 256) -> Index:
    emb = embed_corpus(doc_encoder, token_ids, masks, batch_size)
    return expand_index(index, emb)
