"""The port's subword tokenizers (``gdr_tpu_torch/data/subword.py``) against
``gdr_tpu``'s.  The ``tokenizers`` trainers break ties between equal-scored
pieces by a per-process hash, so two trainings on the same texts (in either
package) can pick and number the pieces differently.  So the two packages'
trained files are held to the same pipeline (normalizer, pre-tokenizer,
post-processor, decoder, special tokens), model type and vocabulary size,
and on one file the two tokenizers give the same ids.  ``load_tokenizer``
resolves a ``.json``."""

import contextlib
import io
import json

import numpy as np
import pytest

from gdr_tpu import cli as jax_cli
from gdr_tpu.data import subword as jax_subword
from gdr_tpu_torch import cli as port_cli
from gdr_tpu_torch.data import subword
from gdr_tpu_torch.data.tokenize import HashTokenizer, load_tokenizer

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "natural questions is a benchmark for open domain question answering",
    "generative dense retrieval clusters documents hierarchically",
    "memory can be a burden for purely generative retrievers",
    "the dense index absorbs new documents without retraining",
    "tokenization splits words into subword units",
] * 4
PROBES = ["the quick brown fox", "dense retrieval without retraining",
          "unseen words like zymurgy", ""]


def _pipeline(path) -> tuple[dict, str, int]:
    """(the file without its model, the model's type, its vocab size)."""
    spec = json.loads(open(path).read())
    model = spec.pop("model")
    return spec, model["type"], len(model["vocab"])


@pytest.mark.parametrize("kind", ["unigram", "wordpiece"])
def test_trained_tokenizer_matches_gdr_tpu(kind, tmp_path):
    train = getattr(subword, f"train_{kind}")
    jax_train = getattr(jax_subword, f"train_{kind}")
    port = train(CORPUS, vocab_size=200, path=str(tmp_path / "port.json"))
    ref = jax_train(CORPUS, vocab_size=200, path=str(tmp_path / "ref.json"))
    assert port.vocab_size == ref.vocab_size
    assert _pipeline(tmp_path / "port.json") == _pipeline(tmp_path / "ref.json")
    # on one file the two packages give the same ids, either way round
    for path in ("port.json", "ref.json"):
        a = subword.SubwordTokenizer(str(tmp_path / path))
        b = jax_subword.SubwordTokenizer(str(tmp_path / path))
        ids, mask = a.encode_batch(PROBES, 16)
        ids_j, mask_j = b.encode_batch(PROBES, 16)
        np.testing.assert_array_equal(ids, ids_j)
        np.testing.assert_array_equal(mask, mask_j)
        one, one_mask = a.encode(PROBES[0], 16)
        np.testing.assert_array_equal(one, ids[0])
        assert a.decode(one[:int(one_mask.sum())]) == \
            b.decode(ids_j[0][:int(mask_j[0].sum())])


def test_load_tokenizer_resolves_json(tmp_path):
    path = str(tmp_path / "wp.json")
    jax_subword.train_wordpiece(CORPUS, vocab_size=150, path=path)
    tok = load_tokenizer(path)
    assert isinstance(tok, subword.SubwordTokenizer)
    assert tok.vocab_size == jax_subword.SubwordTokenizer(path).vocab_size
    # a missing file or no name is the hash tokenizer, as in gdr_tpu
    assert isinstance(load_tokenizer(str(tmp_path / "none.json")),
                      HashTokenizer)
    assert isinstance(load_tokenizer(None, vocab_size=99), HashTokenizer)


@pytest.mark.parametrize("kind", ["unigram", "wordpiece"])
def test_cli_tokenizer_matches_gdr_tpu_cli(kind, tmp_path):
    corpus = tmp_path / "docs.tsv"
    corpus.write_text("".join(f"title {i}\t{t}\n"
                              for i, t in enumerate(CORPUS)))
    outs = []
    for mod, name in ((port_cli, "port.json"), (jax_cli, "ref.json")):
        args = mod.build_parser().parse_args(
            ["tokenizer", "--corpus", str(corpus), "--out",
             str(tmp_path / name), "--type", kind, "--vocab-size", "180"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            args.fn(args)
        outs.append(buf.getvalue().replace(name, "X"))
    # "tokenizer: <type> vocab=<n> → X (smoke: ids)": the smoke ids may be
    # numbered differently (see the module docstring)
    assert [o.split("(smoke")[0] for o in outs] == \
        [outs[1].split("(smoke")[0]] * 2 and "vocab=" in outs[0]
    assert _pipeline(tmp_path / "port.json") == _pipeline(tmp_path / "ref.json")
