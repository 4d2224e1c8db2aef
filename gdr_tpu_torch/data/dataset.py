"""Training and eval set assembly and batch iteration: a host-numpy copy
of ``gdr_tpu/data/dataset.py`` whose batches equal the reference's bit for
bit (same numpy generator, same draws in the same order).

- query-source mixing by ``query_type`` (gtq = ground-truth queries, doc =
  doc-as-query prefixes, aug = random spans; qg, generated queries, is the
  seq2seq slice's);
- positional CID labels per example;
- per-batch sampling of ≤ ``max_intraclass_num`` same-cluster documents as
  contrastive candidates with the positive appended, and of hard-negative
  CID labels from mined pools;
- multi-positive dev rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from gdr_tpu_torch.config import DataConfig, ModelConfig
from gdr_tpu_torch.data.corpus import doc_aug_spans, first_k_words
from gdr_tpu_torch.eval.evaluator import EvalData
from gdr_tpu_torch.ops.codec import digits_to_label


@dataclass
class TrainSet:
    input_ids: np.ndarray    # [Q, S]
    attn_mask: np.ndarray    # [Q, S]
    labels: np.ndarray       # [Q, L]
    label_mask: np.ndarray   # [Q, L]
    pos_idx: np.ndarray      # [Q] positive doc index
    source: list[str]        # provenance tag per row (gtq/qg/doc/aug)
    # per-row mined hard-negative doc pools (ref neg_bm25/neg_random pkls,
    # bm25_preprocess.py:42-61); None → random sampling at batch time
    neg_pool: list[list[int]] | None = None

    def __len__(self) -> int:
        return len(self.pos_idx)

    @staticmethod
    def concat(parts: Sequence["TrainSet"]) -> "TrainSet":
        parts = [p for p in parts if len(p)]
        pools = None
        if any(p.neg_pool is not None for p in parts):
            pools = sum(((p.neg_pool if p.neg_pool is not None
                          else [[] for _ in range(len(p))]) for p in parts),
                        [])
        return TrainSet(
            input_ids=np.concatenate([p.input_ids for p in parts]),
            attn_mask=np.concatenate([p.attn_mask for p in parts]),
            labels=np.concatenate([p.labels for p in parts]),
            label_mask=np.concatenate([p.label_mask for p in parts]),
            pos_idx=np.concatenate([p.pos_idx for p in parts]),
            source=sum((p.source for p in parts), []),
            neg_pool=pools,
        )


def build_train_set(queries: Sequence[str], positives: Sequence[int],
                    doc_paths: Sequence[Sequence[int]], tokenizer,
                    mcfg: ModelConfig, max_input_length: int,
                    source: str = "gtq",
                    label_length_cutoff: bool = False) -> TrainSet:
    """Tokenize queries and attach CID labels of their positive docs.

    ``label_length_cutoff``: truncate CID paths to ``max_output_length - 2``
    digits (ref main_models.py:477-478) — trains on cluster prefixes when
    the tree is deeper than the decoder budget."""
    ids, mask = tokenizer.encode_batch(list(queries), max_input_length)
    q = len(queries)
    labels = np.zeros((q, mcfg.max_output_length), np.int32)
    lmask = np.zeros((q, mcfg.max_output_length), np.int32)
    cut = mcfg.max_output_length - 2
    for i, doc in enumerate(positives):
        path = doc_paths[doc]
        if label_length_cutoff:
            path = path[:cut]
        labels[i], lmask[i] = digits_to_label(
            path, mcfg.kary, mcfg.max_output_length, mcfg.position)
    return TrainSet(input_ids=ids, attn_mask=mask, labels=labels,
                    label_mask=lmask,
                    pos_idx=np.asarray(positives, np.int32),
                    source=[source] * q)


def build_train_set_from_tokens(query_tokens: np.ndarray,
                                query_mask: np.ndarray,
                                positives: Sequence[int],
                                doc_paths: Sequence[Sequence[int]],
                                mcfg: ModelConfig,
                                source: str = "qg") -> TrainSet:
    """Assemble a TrainSet directly from token arrays — the path for
    on-device query generation (no string round-trip)."""
    q = query_tokens.shape[0]
    labels = np.zeros((q, mcfg.max_output_length), np.int32)
    lmask = np.zeros((q, mcfg.max_output_length), np.int32)
    for i, doc in enumerate(positives):
        labels[i], lmask[i] = digits_to_label(
            doc_paths[doc], mcfg.kary, mcfg.max_output_length, mcfg.position)
    return TrainSet(input_ids=np.asarray(query_tokens, np.int32),
                    attn_mask=np.asarray(query_mask, np.int32),
                    labels=labels, label_mask=lmask,
                    pos_idx=np.asarray(positives, np.int32),
                    source=[source] * q)


def mix_sources(query_type: str, **source_sets: TrainSet) -> TrainSet:
    """``query_type`` is an underscore-joined mix, e.g. "gtq_qg_doc_aug"
    (ref main_utils.py:146-223)."""
    wanted = query_type.split("_")
    missing = [w for w in wanted if w not in source_sets]
    if missing:
        raise ValueError(f"query_type needs sources {missing}")
    return TrainSet.concat([source_sets[w] for w in wanted])


class BatchIterator:
    """Shuffled epoch iterator with per-example candidate sampling."""

    def __init__(self, train_set: TrainSet,
                 cluster_docs_of: Sequence[Sequence[int]],
                 batch_size: int, max_intraclass: int, seed: int = 0,
                 drop_last: bool = True, sample_neg_num: int = 0,
                 doc_labels: np.ndarray | None = None,
                 doc_label_mask: np.ndarray | None = None):
        """``cluster_docs_of[doc]``: doc indices sharing doc's cluster.

        ``sample_neg_num`` > 0 adds per-row hard-negative CID labels
        (``neg_labels``/``neg_label_mask`` [B, N, L]) sampled from the
        train set's mined pools (random docs when a row has no pool) —
        ref l1_query hard_negative path, main_models.py:471-472,533-541.
        ``doc_labels``/``doc_label_mask``: [D, L] CID label arrays for every
        corpus doc (the encode of each doc's k-means path)."""
        self.ts = train_set
        self.cluster_docs_of = cluster_docs_of
        self.batch_size = batch_size
        self.c = max_intraclass + 1
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.sample_neg_num = sample_neg_num
        self.doc_labels = doc_labels
        self.doc_label_mask = doc_label_mask
        if sample_neg_num > 0:
            assert doc_labels is not None and doc_label_mask is not None, \
                "sample_neg_num > 0 requires doc_labels/doc_label_mask"
        self.num_docs = len(cluster_docs_of)

    def __iter__(self) -> Iterator[dict]:
        order = self.rng.permutation(len(self.ts))
        bs = self.batch_size
        end = len(order) - (len(order) % bs if self.drop_last else 0)
        for start in range(0, end, bs):
            idx = order[start:start + bs]
            if self.drop_last and len(idx) < bs:
                break
            yield self.make_batch(idx)

    def make_batch(self, idx: np.ndarray) -> dict:
        ts = self.ts
        b = len(idx)
        cand_idx = np.zeros((b, self.c), np.int32)
        cand_mask = np.zeros((b, self.c), bool)
        for row, i in enumerate(idx):
            pos = int(ts.pos_idx[i])
            others = [d for d in self.cluster_docs_of[pos] if d != pos]
            self.rng.shuffle(others)
            chosen = others[: self.c - 1] + [pos]   # positive appended last
            cand_idx[row, :len(chosen)] = chosen
            cand_mask[row, :len(chosen)] = True
        batch = {
            "input_ids": ts.input_ids[idx],
            "attn_mask": ts.attn_mask[idx],
            "labels": ts.labels[idx],
            "label_mask": ts.label_mask[idx],
            "pos_idx": ts.pos_idx[idx],
            "cand_idx": cand_idx,
            "cand_mask": cand_mask,
        }
        if self.sample_neg_num > 0:
            n = self.sample_neg_num
            neg_docs = np.zeros((b, n), np.int32)
            for row, i in enumerate(idx):
                pool = (ts.neg_pool[i] if ts.neg_pool is not None else [])
                pool = [d for d in pool if d != int(ts.pos_idx[i])]
                if pool:
                    neg_docs[row] = self.rng.choice(pool, n)
                else:       # random fallback (ref random_preprocess.py)
                    while True:
                        cand = self.rng.integers(0, self.num_docs, n)
                        if int(ts.pos_idx[i]) not in cand:
                            break
                    neg_docs[row] = cand
            batch["neg_idx"] = neg_docs
            batch["neg_labels"] = self.doc_labels[neg_docs]
            batch["neg_label_mask"] = self.doc_label_mask[neg_docs]
        return batch


def build_eval_data(queries: Sequence[str],
                    positives: Sequence[Sequence[int]],
                    cid_of_doc: Sequence[str], tokenizer,
                    max_input_length: int) -> EvalData:
    """Dev set with multi-positive rows (ref main_utils.py:282-375)."""
    ids, mask = tokenizer.encode_batch(list(queries), max_input_length)
    gt_docs = [[str(d) for d in pos] for pos in positives]
    gt_cids = [sorted({cid_of_doc[d] for d in pos}) for pos in positives]
    return EvalData(input_ids=ids, attn_mask=mask,
                    gt_docs=gt_docs, gt_cids=gt_cids)


def build_doc_query_sets(doc_texts: Sequence[str],
                         doc_paths: Sequence[Sequence[int]], tokenizer,
                         mcfg: ModelConfig, dcfg: DataConfig,
                         rng=None) -> dict[str, TrainSet]:
    """Document-side pseudo-query sources for ``query_type`` mixing:

    - ``doc``: the first ``doc_length`` words of each document as its query
      (ref main.py:412-415 doc-length override);
    - ``aug``: random fixed-length spans, count scaled by document length
      (ref NQ_process.py:147-165 / generate_training_data.py:279-296).
    """
    rng = rng or np.random.default_rng(0)
    doc_q = first_k_words(list(doc_texts), dcfg.doc_length)
    doc_set = build_train_set(doc_q, list(range(len(doc_texts))), doc_paths,
                              tokenizer, mcfg, dcfg.max_input_length,
                              source="doc")
    spans, src = doc_aug_spans(list(doc_texts), aug_len=16, rng=rng)
    aug_set = build_train_set(spans, src, doc_paths, tokenizer, mcfg,
                              dcfg.max_input_length, source="aug")
    return {"doc": doc_set, "aug": aug_set}


def doc_label_arrays(doc_paths: Sequence[Sequence[int]], mcfg: ModelConfig
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Positional CID label arrays for every corpus document — the gather
    source for hard-negative label batches."""
    d = len(doc_paths)
    labels = np.zeros((d, mcfg.max_output_length), np.int32)
    mask = np.zeros((d, mcfg.max_output_length), np.int32)
    for i, p in enumerate(doc_paths):
        labels[i], mask[i] = digits_to_label(p, mcfg.kary,
                                             mcfg.max_output_length,
                                             mcfg.position)
    return labels, mask


def cluster_docs_lookup(cid_of_doc: Sequence[str]) -> list[list[int]]:
    """doc → list of docs sharing its cluster (the sampling pool,
    ref main_models.py:597-604 via ``id_mapping``)."""
    by_cid: dict[str, list[int]] = {}
    for d, cid in enumerate(cid_of_doc):
        by_cid.setdefault(cid, []).append(d)
    return [by_cid[cid] for cid in cid_of_doc]
