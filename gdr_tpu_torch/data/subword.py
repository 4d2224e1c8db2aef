"""Trainable subword tokenization, a copy of ``gdr_tpu/data/subword.py``.

The reference tokenizes queries with a sentencepiece T5 tokenizer and
documents with a WordPiece BERT tokenizer.  Neither vocabulary ships with
the repository, so both are trained over the corpus with the HuggingFace
``tokenizers`` library (imported inside the functions, so that a machine
without it can still import the port):

- :func:`train_unigram` — Unigram LM with a Metaspace pre-tokenizer, the
  algorithm family sentencepiece implements for T5: pad=0, eos(``</s>``)=1,
  an ``</s>`` appended to every sequence.
- :func:`train_wordpiece` — BERT-style WordPiece with ``[CLS] … [SEP]``
  framing and pad=0, for the document tower.

Both save one JSON file; :class:`SubwordTokenizer` loads it behind the same
``encode/encode_batch → (ids, mask)`` interface as the hash tokenizer
(``data/tokenize.py``), and ``load_tokenizer`` resolves a ``.json`` path to
it.  The ids equal the reference package's for the same file.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

PAD, EOS = 0, 1


def train_unigram(texts: Iterable[str], vocab_size: int, path: str,
                  lower: bool = True) -> "SubwordTokenizer":
    """Train a T5-style Unigram tokenizer and save it to ``path`` (JSON)."""
    from tokenizers import Tokenizer, decoders, models, normalizers, \
        pre_tokenizers, processors, trainers

    tok = Tokenizer(models.Unigram())
    tok.decoder = decoders.Metaspace()
    norms = [normalizers.NFKC()]
    if lower:
        norms.append(normalizers.Lowercase())
    tok.normalizer = normalizers.Sequence(norms)
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    trainer = trainers.UnigramTrainer(
        vocab_size=vocab_size, unk_token="<unk>",
        special_tokens=["<pad>", "</s>", "<unk>"])
    tok.train_from_iterator(texts, trainer)
    eos = tok.token_to_id("</s>")
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>",
        special_tokens=[("</s>", eos)])
    tok.save(path)
    return SubwordTokenizer(path)


def train_wordpiece(texts: Iterable[str], vocab_size: int, path: str,
                    lower: bool = True) -> "SubwordTokenizer":
    """Train a BERT-style WordPiece tokenizer and save it to ``path``."""
    from tokenizers import Tokenizer, decoders, models, normalizers, \
        pre_tokenizers, processors, trainers

    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.decoder = decoders.WordPiece()
    tok.normalizer = normalizers.BertNormalizer(lowercase=lower)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    trainer = trainers.WordPieceTrainer(
        vocab_size=vocab_size,
        special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    tok.train_from_iterator(texts, trainer)
    cls, sep = tok.token_to_id("[CLS]"), tok.token_to_id("[SEP]")
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", cls), ("[SEP]", sep)])
    tok.save(path)
    return SubwordTokenizer(path)


class SubwordTokenizer:
    """A trained ``tokenizers`` JSON model behind the (ids, mask) API."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer
        self.tok = Tokenizer.from_file(path)
        self.path = path
        self.vocab_size = self.tok.get_vocab_size()

    def encode(self, text: str, max_length: int
               ) -> tuple[np.ndarray, np.ndarray]:
        ids, mask = self.encode_batch([text], max_length)
        return ids[0], mask[0]

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        encs = self.tok.encode_batch(list(texts))
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, e in enumerate(encs):
            row = e.ids[:max_length]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode([int(i) for i in ids])
