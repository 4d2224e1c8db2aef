"""Corpus ingest and document-side pseudo-queries: a copy of
``gdr_tpu/data/corpus.py``.

Simplified Natural Questions jsonl (or the pickled 334k-document corpus
with its query records) → a document table deduplicated by title, (query,
positive doc ids) rows, and random word spans of each document as
pseudo-queries.  Text is lowercased with its quotes and newlines removed.
Host-side data prep: lists out, no framework.
"""

from __future__ import annotations

import gzip
import json
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Corpus:
    titles: list[str] = field(default_factory=list)
    texts: list[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.titles)


@dataclass
class QuerySet:
    queries: list[str] = field(default_factory=list)
    doc_ids: list[list[int]] = field(default_factory=list)  # positives per query

    def __len__(self) -> int:
        return len(self.queries)


def _normalize(text: str) -> str:
    text = text.replace("\n", " ").replace("``", "").replace('"', "")
    return re.sub(r"\s+", " ", text).strip().lower()


def _ingest_nq_into(path: str, corpus: Corpus, title_to_id: dict[str, int],
                    queries: QuerySet, max_records: int | None) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            if max_records is not None and i >= max_records:
                break
            rec = json.loads(line)
            title = rec.get("document_title", f"doc-{i}")
            if title not in title_to_id:
                title_to_id[title] = len(corpus.titles)
                corpus.titles.append(title)
                corpus.texts.append(_normalize(rec.get("document_text", "")))
            doc_id = title_to_id[title]
            q = _normalize(rec.get("question_text", ""))
            if q:
                queries.queries.append(q)
                queries.doc_ids.append([doc_id])


def ingest_nq_jsonl(path: str, max_records: int | None = None
                    ) -> tuple[Corpus, QuerySet]:
    """Parse simplified NQ jsonl(.gz): one record per question with
    ``document_title`` / ``document_text`` / ``question_text``.  Documents
    dedup by title (ref notebook cell 10: 109,739 unique docs); queries keep
    every positive."""
    corpus, queries = Corpus(), QuerySet()
    _ingest_nq_into(path, corpus, {}, queries, max_records)
    return corpus, queries


def ingest_nq_splits(train_path: str, dev_path: str | None = None,
                     max_records: int | None = None
                     ) -> tuple[Corpus, QuerySet, QuerySet | None]:
    """Train + dev jsonl over ONE shared corpus (the reference ingests
    v1.0-simplified train/dev separately but retrieves against a single
    document table, NQ_process.py:112-134): dev documents not seen in train
    are appended to the corpus so their doc ids stay consistent."""
    corpus, train_q = Corpus(), QuerySet()
    title_to_id: dict[str, int] = {}
    _ingest_nq_into(train_path, corpus, title_to_id, train_q, max_records)
    dev_q = None
    if dev_path is not None:
        dev_q = QuerySet()
        _ingest_nq_into(dev_path, corpus, title_to_id, dev_q, max_records)
    return corpus, train_q, dev_q


def queries_from_records(data_records: list[dict],
                         title_to_id: dict[str, int]) -> QuerySet:
    """Map pickle-style query records onto an existing title→id table;
    ``data_records``: [{"query", "positive_passages": [{"title"} ...]}]."""
    queries = QuerySet()
    for rec in data_records:
        pos = [title_to_id[p["title"]] for p in rec["positive_passages"]
               if p["title"] in title_to_id]
        if pos:
            queries.queries.append(_normalize(rec["query"]))
            queries.doc_ids.append(sorted(set(pos)))
    return queries


def corpus_from_records(corpus_records: list[dict]
                        ) -> tuple[Corpus, dict[str, int]]:
    corpus = Corpus()
    title_to_id: dict[str, int] = {}
    for rec in corpus_records:
        title_to_id[rec["title"]] = len(corpus.titles)
        corpus.titles.append(rec["title"])
        corpus.texts.append(_normalize(rec["text"]))
    return corpus, title_to_id


def ingest_pickle_corpus(corpus_records: list[dict],
                         data_records: list[dict]) -> tuple[Corpus, QuerySet]:
    """The 334,314-doc pipeline variant (generate_training_data.py:26-201):
    ``corpus_records``: [{"title", "text"}]; ``data_records``:
    [{"query", "positive_passages": [{"title"} ...]}]."""
    corpus, title_to_id = corpus_from_records(corpus_records)
    return corpus, queries_from_records(data_records, title_to_id)


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
