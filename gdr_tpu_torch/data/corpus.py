"""Document-side pseudo-queries (a copy of ``doc_aug_spans`` and
``first_k_words`` from ``gdr_tpu/data/corpus.py``; the raw-corpus ingest
there is a later slice)."""

from __future__ import annotations

import numpy as np


def doc_aug_spans(texts: list[str], aug_len: int = 16, rng=None,
                  spans_per_1k_words: float = 1.0,
                  max_spans: int = 10) -> tuple[list[str], list[int]]:
    """Random fixed-length word spans as pseudo-queries, their count
    scaled by the document's length.  Returns (span_texts,
    source_doc_ids)."""
    rng = rng or np.random.default_rng(0)
    spans, src = [], []
    for doc_id, text in enumerate(texts):
        words = text.split()
        if len(words) <= aug_len:
            n = 1 if words else 0
        else:
            n = min(max_spans,
                    max(1, int(len(words) / 1000 * spans_per_1k_words * 10)))
        for _ in range(n):
            if len(words) <= aug_len:
                spans.append(" ".join(words))
            else:
                start = int(rng.integers(0, len(words) - aug_len))
                spans.append(" ".join(words[start:start + aug_len]))
            src.append(doc_id)
    return spans, src


def first_k_words(texts: list[str], k: int) -> list[str]:
    """Doc-as-query truncation (``doc_length``)."""
    return [" ".join(t.split()[:k]) for t in texts]
