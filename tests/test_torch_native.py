"""The port's host C++ library (``gdr_tpu_torch/native.py`` over
``csrc/host/gdr_native.cpp``) against its pure-Python oracles and against
``gdr_tpu``'s: trie arrays, hash-token ids and line offsets are equal."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gdr_tpu import native as jax_native
from gdr_tpu.data.tokenize import HashTokenizer as JaxHashTokenizer
from gdr_tpu.ops.trie import build_trie as jax_build_trie
from gdr_tpu_torch import native
from gdr_tpu_torch.data.tokenize import HashTokenizer
from gdr_tpu_torch.ops.trie import _build_trie_python, build_trie

ROOT = Path(__file__).resolve().parents[1]
TRIE_FIELDS = ("children", "eos_allowed", "depth", "doc_start", "doc_count",
               "doc_indices", "cluster_of_node", "cluster_node_ids",
               "cluster_docs", "cluster_doc_mask")
TEXTS = ["What is the Capital of France?",
         "the quick brown fox... jumps; over_the lazy dog (2024)!",
         "", "a", "punctuation:,.;!?" * 3, "Tab\tseparated\nand new lines",
         "x" * 40 + " y"]


def _cid_world(seed: int, n_cids: int, kary: int, max_depth: int):
    """A prefix-free {CID: docs} mapping, like a k-means tree's leaves."""
    rng = np.random.default_rng(seed)
    cid_to_docs, doc = {}, 0
    while len(cid_to_docs) < n_cids:
        depth = int(rng.integers(1, max_depth + 1))
        cid = "-".join(str(int(d)) for d in rng.integers(0, kary, depth))
        if cid in cid_to_docs or any(c.startswith(cid + "-")
                                     or cid.startswith(c + "-")
                                     for c in cid_to_docs):
            continue
        k = int(rng.integers(1, 6))
        cid_to_docs[cid] = list(range(doc, doc + k))
        doc += k
    return cid_to_docs


@pytest.mark.parametrize("seed,n_cids,kary,max_depth",
                         [(0, 200, 7, 4), (1, 60, 30, 3), (2, 1, 5, 1)])
def test_trie_packer_matches_python_and_gdr_tpu(seed, n_cids, kary,
                                                max_depth):
    cid_to_docs = _cid_world(seed, n_cids, kary, max_depth)
    got = build_trie(cid_to_docs, kary, max_docs_per_cluster=4)
    oracle = _build_trie_python(cid_to_docs, kary, max_docs_per_cluster=4)
    refs = [jax_build_trie(cid_to_docs, kary, 4, use_native=False)]
    if jax_native.available():
        refs.append(jax_build_trie(cid_to_docs, kary, 4, use_native=True))
    for f in TRIE_FIELDS:
        for want in [oracle, *refs]:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


def test_trie_packer_root_cid():
    # every doc at the root (a corpus no larger than the leaf cap)
    got = build_trie({"": [0, 1, 2]}, 4)
    want = _build_trie_python({"": [0, 1, 2]}, 4)
    for f in TRIE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.num_nodes == 1 and bool(got.eos_allowed[0])


def test_trie_packer_refuses_a_path_spelled_twice():
    with pytest.raises(ValueError, match="two ways"):
        build_trie({"1-2": [0], "01-2": [1]}, 4)


@pytest.mark.parametrize("vocab,lower", [(997, True), (32128, False)])
def test_hash_tokenizer_batch_matches_python_and_gdr_tpu(vocab, lower):
    tok = HashTokenizer(vocab_size=vocab, lower=lower)
    ids, mask = tok.encode_batch(TEXTS, 24)
    oracle = [tok.encode(t, 24) for t in TEXTS]
    np.testing.assert_array_equal(ids, np.stack([i for i, _ in oracle]))
    np.testing.assert_array_equal(mask, np.stack([m for _, m in oracle]))
    ref = JaxHashTokenizer(vocab_size=vocab, lower=lower, use_native=False)
    ids_j, mask_j = ref.encode_batch(TEXTS, 24)
    np.testing.assert_array_equal(ids, ids_j)
    np.testing.assert_array_equal(mask, mask_j)
    if jax_native.available():
        np.testing.assert_array_equal(
            ids, jax_native.hash_encode_batch(TEXTS, 24, vocab, lower)[0])


def test_hash_tokenizer_refuses_a_tiny_vocab():
    with pytest.raises(ValueError, match="vocab_size"):
        native.hash_encode_batch(["a"], 4, 2, True)


@pytest.mark.parametrize("data", [b"row1\trow1b\nrow2\nrow3\t3b\n",
                                  b"no newline at the end", b"", b"\n\n"])
def test_scan_lines_matches_python_and_gdr_tpu(data):
    got = native.scan_lines(data)
    starts = [0] + [i + 1 for i, c in enumerate(data)
                    if c == ord("\n") and i + 1 < len(data)]
    want = (starts if data else []) + [len(data)]
    assert got.tolist() == want
    if jax_native.available():
        assert jax_native.scan_lines(data).tolist() == want


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")          # a "compiler" that fails
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list(tmp_path.iterdir())         # no temporary left behind
    monkeypatch.setenv("CXX", "no-such-compiler-gdr")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()


def test_concurrent_builds_load_one_library(tmp_path):
    # processes that build at once (pytest-xdist workers) each load a whole
    # library: the compiler writes a temporary file that is renamed in
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from gdr_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = ctypes.CDLL(str(native.build()))\n"
        "print(lib.gdr_scan_lines is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert [o.strip() for o, _ in outs] == ["True"] * 4
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
