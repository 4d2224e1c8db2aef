"""Negative mining, BM25 and random (a host copy of
``gdr_tpu/data/negatives.py``): a compact sparse BM25 over lower-cased word
tokens, numpy only, and uniform random negatives from a seeded numpy
generator.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Sequence

import numpy as np


class BM25Index:
    def __init__(self, docs: Sequence[str], k1: float = 1.5, b: float = 0.75):
        self.k1, self.b = k1, b
        self.doc_terms = [Counter(self._terms(d)) for d in docs]
        self.doc_len = np.asarray([sum(c.values()) for c in self.doc_terms],
                                  np.float32)
        self.avg_len = float(self.doc_len.mean()) if len(docs) else 0.0
        self.df: dict[str, int] = defaultdict(int)
        for c in self.doc_terms:
            for t in c:
                self.df[t] += 1
        self.n = len(docs)
        self.postings: dict[str, list[tuple[int, int]]] = defaultdict(list)
        for i, c in enumerate(self.doc_terms):
            for t, f in c.items():
                self.postings[t].append((i, f))

    @staticmethod
    def _terms(text: str) -> list[str]:
        return re.findall(r"\w+", text.lower())

    def _idf(self, t: str) -> float:
        df = self.df.get(t, 0)
        return math.log(1 + (self.n - df + 0.5) / (df + 0.5))

    def scores(self, query: str) -> np.ndarray:
        s = np.zeros(self.n, np.float32)
        for t in self._terms(query):
            idf = self._idf(t)
            for i, f in self.postings.get(t, ()):  # sparse accumulate
                denom = f + self.k1 * (1 - self.b
                                       + self.b * self.doc_len[i] / self.avg_len)
                s[i] += idf * f * (self.k1 + 1) / denom
        return s

    def top_k(self, query: str, k: int,
              exclude: Sequence[int] = ()) -> list[int]:
        s = self.scores(query)
        for e in exclude:
            s[e] = -np.inf
        k = min(k, self.n)
        idx = np.argpartition(-s, k - 1)[:k]
        return [int(i) for i in idx[np.argsort(-s[idx])]]


def bm25_negatives(queries: Sequence[str], positives: Sequence[Sequence[int]],
                   docs: Sequence[str], k: int = 30) -> list[list[int]]:
    """Top-k BM25 docs per query, positives excluded
    (ref bm25_preprocess.py:42-61)."""
    index = BM25Index(docs)
    return [index.top_k(q, k, exclude=pos)
            for q, pos in zip(queries, positives)]


def random_negatives(num_queries: int, num_docs: int,
                     positives: Sequence[Sequence[int]], k: int = 30,
                     seed: int = 0) -> list[list[int]]:
    """Uniform random negatives (ref random_preprocess.py:66-72)."""
    rng = np.random.default_rng(seed)
    out = []
    for qi in range(num_queries):
        pos = set(positives[qi])
        neg: list[int] = []
        while len(neg) < min(k, num_docs - len(pos)):
            c = int(rng.integers(0, num_docs))
            if c not in pos and c not in neg:
                neg.append(c)
        out.append(neg)
    return out
