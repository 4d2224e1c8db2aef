"""Tokenizers (a copy of ``HashTokenizer``, ``HFTokenizer`` and
``load_tokenizer`` from ``gdr_tpu/data/tokenize.py``).

The hashing tokenizer keeps the pipeline hermetic; its ids are identical to
the reference package's (same FNV-1a word hash).  Batches are encoded by the
port's host C++ library (``native.py``); ``HashTokenizer.encode`` is the
pure-Python oracle it is held to.  The model only ever sees the [B, L]
int32 arrays these produce.
"""

from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np

from gdr_tpu_torch import native


def fnv1a(data: bytes) -> int:
    """32-bit FNV-1a."""
    h = 0x811C9DC5
    for byte in data:
        h = ((h ^ byte) * 0x01000193) & 0xFFFFFFFF
    return h


class HashTokenizer:
    """Deterministic word-hash tokenizer: token = 2 + (fnv1a(word) % (V-2));
    ids 0/1 stay reserved (pad/eos).  Words are ``\\w+`` runs and single
    punctuation characters; the C++ batch encoder reads ASCII the same way
    and counts every byte ≥ 0x80 as a word byte, as the reference
    package's does."""

    def __init__(self, vocab_size: int = 32128, lower: bool = True):
        self.vocab_size = vocab_size
        self.lower = lower

    def _word_id(self, w: str) -> int:
        return 2 + fnv1a(w.encode()) % (self.vocab_size - 2)

    def encode(self, text: str, max_length: int) -> tuple[np.ndarray, np.ndarray]:
        if self.lower:
            text = text.lower()
        words = re.findall(r"\w+|[^\w\s]", text)[: max_length]
        ids = np.zeros(max_length, np.int32)
        for i, w in enumerate(words):
            ids[i] = self._word_id(w)
        mask = (ids != 0).astype(np.int32)
        return ids, mask

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        return native.hash_encode_batch(texts, max_length, self.vocab_size,
                                        self.lower)


class HFTokenizer:
    """A HuggingFace tokenizer (local files only) behind the same interface."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(name_or_path,
                                                 local_files_only=True)
        self.vocab_size = self.tok.vocab_size

    def encode_batch(self, texts: Sequence[str], max_length: int):
        out = self.tok(list(texts), max_length=max_length,
                       padding="max_length", truncation=True,
                       return_tensors="np")
        return (out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32))


def load_tokenizer(name_or_path: str | None, vocab_size: int = 32128):
    """A ``.json`` file → the in-repo trained subword model
    (``data/subword.py``); a directory / HF name → HuggingFace tokenizer
    (local files only); otherwise the deterministic hash tokenizer."""
    if name_or_path:
        if name_or_path.endswith(".json") and os.path.isfile(name_or_path):
            from gdr_tpu_torch.data.subword import SubwordTokenizer
            return SubwordTokenizer(name_or_path)
        try:
            return HFTokenizer(name_or_path)
        except Exception:   # noqa: BLE001
            # no transformers, or no tokenizer files: a checkpoint directory
            # holding only config.json and weights makes transformers raise
            # AttributeError or TypeError as well as OSError / ValueError;
            # the hash tokenizer stands in, as in the reference package
            pass
    return HashTokenizer(vocab_size=vocab_size)
