"""Synthetic retrieval tasks for tests, demos and the chip smoke test,
mirroring ``gdr_tpu/data/synthetic.py``: a miniature GDR world of
blob-structured document embeddings → hierarchical k-means (the port's
``ops/kmeans.py``; under 20,000 docs its host path, the reference's exactly)
→ CID trie → one query per document with its CID labels and same-cluster
contrastive candidates.  Host numpy, the same draws in the same order as
the reference, so both packages build the same task from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gdr_tpu_torch.ops.codec import digits_to_label
from gdr_tpu_torch.ops.kmeans import (hierarchical_kmeans,
                                      paths_to_cid_mapping)
from gdr_tpu_torch.ops.trie import TrieTensors, build_trie


@dataclass
class SyntheticTask:
    store: np.ndarray            # [N, dim] doc embeddings
    trie: TrieTensors
    paths: list[list[int]]       # digit path per doc
    cid_of_doc: list[str]
    # per-query training arrays (one query per doc by default)
    input_ids: np.ndarray        # [Q, S]
    attn_mask: np.ndarray        # [Q, S]
    labels: np.ndarray           # [Q, L]
    label_mask: np.ndarray       # [Q, L]
    pos_idx: np.ndarray          # [Q] positive doc id
    cand_idx: np.ndarray         # [Q, C] same-cluster candidates (incl. positive)
    cand_mask: np.ndarray        # [Q, C]
    gt_docs: list[list[str]]
    gt_cids: list[list[str]]


def build_synthetic_task(n_docs: int = 24, dim: int = 16, kary: int = 3,
                         leaf_cap: int = 4, seq_len: int = 8,
                         vocab_size: int = 128, max_output_length: int = 5,
                         max_intraclass: int = 4, n_blobs: int = 6,
                         seed: int = 0) -> SyntheticTask:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_blobs, dim)) * 8.0
    blob = rng.integers(0, n_blobs, size=n_docs)
    store = (centers[blob] + rng.normal(size=(n_docs, dim))).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)

    paths = hierarchical_kmeans(store, kary=kary, leaf_cap=leaf_cap,
                                iters=15, seed=seed,
                                max_depth=max_output_length - 2)
    mapping = paths_to_cid_mapping(paths)
    trie = build_trie(mapping, kary=kary,
                      max_docs_per_cluster=max(leaf_cap * 2, 8),
                      doc_embeddings=store)
    cid_of_doc = ["-".join(str(d) for d in p) for p in paths]

    q = n_docs
    input_ids = rng.integers(2, vocab_size, size=(q, seq_len)).astype(np.int32)
    attn_mask = np.ones((q, seq_len), np.int32)
    labels = np.zeros((q, max_output_length), np.int32)
    label_mask = np.zeros((q, max_output_length), np.int32)
    for i in range(q):
        labels[i], label_mask[i] = digits_to_label(
            paths[i], kary, max_output_length)

    c = max_intraclass + 1
    cand_idx = np.zeros((q, c), np.int32)
    cand_mask = np.zeros((q, c), bool)
    for i in range(q):
        cluster_docs = [d for d in mapping[cid_of_doc[i]]]
        others = [d for d in cluster_docs if d != i]
        rng.shuffle(others)
        chosen = others[:max_intraclass] + [i]      # positive appended last
        cand_idx[i, :len(chosen)] = chosen
        cand_mask[i, :len(chosen)] = True

    return SyntheticTask(
        store=store, trie=trie, paths=paths, cid_of_doc=cid_of_doc,
        input_ids=input_ids, attn_mask=attn_mask, labels=labels,
        label_mask=label_mask, pos_idx=np.arange(q, dtype=np.int32),
        cand_idx=cand_idx, cand_mask=cand_mask,
        gt_docs=[[str(i)] for i in range(q)],
        gt_cids=[[cid_of_doc[i]] for i in range(q)],
    )


def batch_slice(task: SyntheticTask, idx: np.ndarray) -> dict:
    """Assemble a stage-1 train batch dict from query indices."""
    return {
        "input_ids": task.input_ids[idx],
        "attn_mask": task.attn_mask[idx],
        "labels": task.labels[idx],
        "label_mask": task.label_mask[idx],
        "pos_idx": task.pos_idx[idx],
        "cand_idx": task.cand_idx[idx],
        "cand_mask": task.cand_mask[idx],
    }
