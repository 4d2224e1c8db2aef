"""``python -m gdr_tpu_torch.cli retrieve|eval|calculate --device cpu``
against the JAX package's CLI: the same index file (written by the JAX
package's ``save_index``), the same weights (the reference CLI's seeded init,
exported by tools/export_gdr_tpu_params.py), the same ranked documents,
metrics and result TSV.  ``index`` → ``expand`` → ``retrieve`` on a corpus
TSV, with the tiny doc tower the tool exports from the reference's init:
the same store as the reference CLI's ``index`` (within 1e-5), the trie
``gdr_tpu`` builds from the port's store, and the expansion ``gdr_tpu``'s
CLI makes of the port's index."""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gdr_tpu import cli as jax_cli
from gdr_tpu.config import IndexConfig as JaxIndexConfig
from gdr_tpu.index.builder import Index as JaxIndex
from gdr_tpu.index.builder import build_index_from_embeddings
from gdr_tpu.index.io import load_index as jax_load_index
from gdr_tpu.index.io import save_index as jax_save_index
from gdr_tpu.ops.trie import build_trie as jax_build_trie
from gdr_tpu_torch import cli as port_cli
from gdr_tpu_torch.index.io import Index, load_index, save_index
from torch_port_helpers import small_cid_map

ROOT = Path(__file__).resolve().parents[1]
MODEL_FLAGS = ["--model-size", "tiny", "--kary", "4", "--max-output-length",
               "5", "--adaptor-layers", "1"]
QUERIES = ["alpha beta gamma", "what is the delta of epsilon", "zeta eta"]
DEV = [("alpha beta gamma", "3"), ("what is the delta of epsilon", "10,11"),
       ("zeta eta", "40"), ("theta iota kappa", "72"), ("lambda mu", "0,5")]
TIMER_KEYS = {"retrieve_total_s", "retrieve_mean_ms", "decode_host_total_s",
              "decode_host_mean_ms"}


@pytest.fixture(scope="module")
def index_path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    cid_to_docs = small_cid_map()
    trie = jax_build_trie(cid_to_docs, 4, use_native=False)
    n = sum(len(v) for v in cid_to_docs.values())
    paths = [None] * n
    for cid, docs in cid_to_docs.items():
        for d in docs:
            paths[d] = [int(c) for c in cid.split("-")]
    store = np.random.default_rng(0).normal(size=(n, 64)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    path = str(tmp / "index.npz")
    jax_save_index(path, JaxIndex(store=store, trie=trie, paths=paths,
                                  cid_of_doc=["-".join(map(str, p))
                                              for p in paths]))
    return path


def test_index_files_interchange(index_path, tmp_path):
    got = load_index(index_path)
    want = jax_load_index(index_path)
    np.testing.assert_array_equal(got.store, want.store)
    np.testing.assert_array_equal(got.trie.children, want.trie.children)
    assert got.cid_of_doc == want.cid_of_doc
    back = str(tmp_path / "port.npz")
    save_index(back, Index(store=got.store, trie=got.trie, paths=got.paths,
                           cid_of_doc=got.cid_of_doc))
    again = jax_load_index(back)
    np.testing.assert_array_equal(again.trie.cluster_docs,
                                  want.trie.cluster_docs)


def _results(text: str):
    rows = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    return [(r["query"], [(h["doc_id"], h["score"], h["cid"])
                          for h in r["results"]]) for r in rows]


def _tool(argv) -> None:
    spec = importlib.util.spec_from_file_location(
        "export_gdr_tpu_params", ROOT / "tools" / "export_gdr_tpu_params.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main(argv)


def _export(workdir, index_path) -> None:
    _tool(["--workdir", str(workdir), "--index", index_path, *MODEL_FLAGS])
    assert (workdir / "params.npz").exists()


def _jax_cli(argv) -> str:
    """Run the JAX CLI in this process; returns its standard output."""
    args = jax_cli.build_parser().parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        args.fn(args)                              # no checkpoint → seed 42
    return buf.getvalue()


def _port_cli(argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "gdr_tpu_torch.cli", *argv], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out


def _retrieve_matches(index_path, workdir, store_flags) -> None:
    """``retrieve --json`` gives the same hits through both CLIs."""
    common = ["--index", index_path, "--workdir", str(workdir), *MODEL_FLAGS,
              "--beam", "8", "--top-k", "6", "--batch-size", "2",
              *store_flags, "--json", "--max-input-length", "12"]
    for q in QUERIES:
        common += ["--query", q]
    want = _results(_jax_cli(["retrieve", *common]))
    _export(workdir, index_path)
    out = _port_cli(["retrieve", *common, "--device", "cpu"])
    assert "loaded" in out.stderr
    got = _results(out.stdout)
    assert [q for q, _ in got] == QUERIES == [q for q, _ in want]
    for (_, hits_t), (_, hits_j) in zip(got, want):
        assert hits_j
        assert [(d, c) for d, _, c in hits_t] == [(d, c) for d, _, c in hits_j]
        np.testing.assert_allclose([s for _, s, _ in hits_t],
                                   [s for _, s, _ in hits_j], atol=2e-6)


def test_cli_retrieve_matches_jax_cli(index_path, tmp_path):
    _retrieve_matches(index_path, tmp_path / "run", ["--packed"])


def test_cli_retrieve_int8_store_matches_jax_cli(index_path, tmp_path):
    _retrieve_matches(index_path, tmp_path / "run", ["--int8-store"])


@pytest.fixture(scope="module")
def eval_runs(index_path, tmp_path_factory):
    """``eval --packed --int8-store --result-tsv`` through both CLIs."""
    tmp = tmp_path_factory.mktemp("torch_cli_eval")
    dev = tmp / "dev.tsv"
    dev.write_text("".join(f"{q}\t{d}\n" for q, d in DEV))
    workdir = tmp / "run"
    common = ["--index", index_path, "--dev", str(dev), "--workdir",
              str(workdir), *MODEL_FLAGS, "--beam", "8", "--eval-batch-size",
              "2", "--max-input-length", "12", "--packed", "--int8-store"]
    jax_tsv, port_tsv = tmp / "jax.tsv", tmp / "port.tsv"
    jax_out = _jax_cli(["eval", *common, "--result-tsv", str(jax_tsv)])
    _export(workdir, index_path)
    port = _port_cli(["eval", *common, "--result-tsv", str(port_tsv),
                      "--device", "cpu"])
    return dict(jax_out=jax_out, port_out=port.stdout, jax_tsv=jax_tsv,
                port_tsv=port_tsv)


def _metrics(stdout: str) -> dict:
    return json.loads(stdout[stdout.index("{"):])


def test_cli_eval_matches_jax_cli(eval_runs):
    got, want = _metrics(eval_runs["port_out"]), _metrics(eval_runs["jax_out"])
    assert set(got) == set(want) and TIMER_KEYS <= set(got)
    assert want["recall100_1.0"] > 0
    for k, v in got.items():
        if k not in TIMER_KEYS:
            assert v == pytest.approx(want[k], abs=1e-9), k
    assert eval_runs["port_tsv"].read_bytes() == \
        eval_runs["jax_tsv"].read_bytes()
    assert len(eval_runs["port_tsv"].read_text().splitlines()) == len(DEV)


@pytest.mark.parametrize("flags", [[], ["--ref-compat"]],
                         ids=["default", "ref_compat"])
def test_cli_calculate_matches_jax_cli(eval_runs, flags):
    want = _jax_cli(["calculate", "--result", str(eval_runs["jax_tsv"]),
                     *flags])
    got = _port_cli(["calculate", "--result", str(eval_runs["port_tsv"]),
                     *flags]).stdout
    assert got == want and json.loads(got)


def test_cli_eval_top_k_runs(index_path, eval_runs, tmp_path):
    # sampled decoding: the JAX CLI's metric keys, the beam run's JSON
    dev = tmp_path / "dev.tsv"
    dev.write_text("".join(f"{q}\t{d}\n" for q, d in DEV))
    out = _port_cli(["eval", "--index", index_path, "--dev", str(dev),
                     "--workdir", str(tmp_path / "run"), *MODEL_FLAGS,
                     "--beam", "8", "--eval-batch-size", "2",
                     "--max-input-length", "12", "--packed",
                     "--gen-method", "top_k", "--sample-top-k", "2",
                     "--temperature", "0.7", "--device", "cpu"])
    got, beam = _metrics(out.stdout), _metrics(eval_runs["port_out"])
    assert set(got) == set(beam)
    assert all(0.0 <= v <= 1.0 for k, v in got.items()
               if k not in TIMER_KEYS)


@pytest.mark.parametrize("flags", [["--ensemble", "2"], ["--mesh", "auto"]],
                         ids=["ensemble", "mesh"])
def test_cli_eval_refuses_unported_modes(flags, tmp_path):
    """Both are ported: ``--ensemble`` and ``--mesh auto`` (in a world of
    one process, no mesh) get as far as reading the (missing) index."""
    args = port_cli.build_parser().parse_args(
        ["eval", "--index", str(tmp_path / "none.npz"), "--dev",
         str(tmp_path / "none.tsv"), "--workdir", str(tmp_path), "--device",
         "cpu", *flags])
    with pytest.raises(FileNotFoundError, match="none.npz"):
        args.fn(args)


def test_cli_refuses_cuda_without_a_card(index_path, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "gdr_tpu_torch.cli", "retrieve", "--index",
         index_path, "--workdir", str(tmp_path), "--query", "x",
         *MODEL_FLAGS], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega").split()
TOWER_FLAGS = ["--encoder-size", "tiny", "--encoder-max-len", "16"]


def _write_corpus(path, n: int, seed: int, tag: str) -> None:
    rng = np.random.default_rng(seed)
    path.write_text("".join(
        f"{tag} {i}\t{' '.join(rng.choice(WORDS, int(rng.integers(3, 14))))}\n"
        for i in range(n)))


@pytest.fixture(scope="module")
def index_chain(tmp_path_factory):
    """The port's ``index`` then ``expand`` over a corpus TSV, the
    reference CLI's ``index`` of the same corpus and its ``expand`` of the
    port's index, all with the tool's export of the tiny tower's init."""
    tmp = tmp_path_factory.mktemp("torch_cli_index")
    _write_corpus(tmp / "docs.tsv", 150, 0, "doc")
    _write_corpus(tmp / "new.tsv", 20, 1, "new")
    enc = str(tmp / "enc.npz")
    _tool(["--doc-encoder", "tiny", "--out", enc])
    shape = ["--kary", "4", "--leaf-cap", "8"]
    out = _port_cli(["index", "--corpus", str(tmp / "docs.tsv"), "--out",
                     str(tmp / "port.npz"), *shape, *TOWER_FLAGS,
                     "--encoder-ckpt", enc, "--device", "cpu"])
    assert "index: 150 docs" in out.stdout and enc in out.stderr
    _port_cli(["expand", "--index", str(tmp / "port.npz"), "--corpus",
               str(tmp / "new.tsv"), "--out", str(tmp / "port2.npz"),
               *TOWER_FLAGS, "--encoder-ckpt", enc, "--device", "cpu"])
    _jax_cli(["index", "--corpus", str(tmp / "docs.tsv"), "--out",
              str(tmp / "ref.npz"), *shape, *TOWER_FLAGS])
    _jax_cli(["expand", "--index", str(tmp / "port.npz"), "--corpus",
              str(tmp / "new.tsv"), "--out", str(tmp / "ref2.npz"),
              *TOWER_FLAGS])
    return tmp


def _same_tries(a, b) -> None:
    for f in ("children", "eos_allowed", "depth", "doc_start", "doc_count",
              "doc_indices", "cluster_node_ids", "cluster_docs",
              "cluster_doc_mask", "leaf_count"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    np.testing.assert_allclose(a.node_embedding, b.node_embedding, rtol=0,
                               atol=1e-6)


def test_cli_index_matches_gdr_tpu_cli(index_chain):
    port = load_index(str(index_chain / "port.npz"))
    ref = jax_load_index(str(index_chain / "ref.npz"))
    assert port.store.shape == ref.store.shape == (150, 32)
    np.testing.assert_allclose(port.store, ref.store, rtol=0, atol=1e-5)
    want = build_index_from_embeddings(port.store, JaxIndexConfig(
        kary=4, leaf_cap=8, seed=7, embedding_dim=32))
    _same_tries(port.trie, want.trie)
    assert port.paths == want.paths and port.trie.num_clusters > 10


def test_cli_expand_matches_gdr_tpu_cli_then_retrieves(index_chain):
    base = load_index(str(index_chain / "port.npz"))
    big = load_index(str(index_chain / "port2.npz"))
    ref = jax_load_index(str(index_chain / "ref2.npz"))
    assert len(big.paths) == len(big.store) == 170
    np.testing.assert_array_equal(big.store[:150], base.store)
    np.testing.assert_allclose(big.store, ref.store, rtol=0, atol=1e-5)
    _same_tries(big.trie, ref.trie)
    assert big.cid_of_doc == ref.cid_of_doc
    for f in ("children", "eos_allowed", "depth"):
        np.testing.assert_array_equal(getattr(big.trie, f),
                                      getattr(base.trie, f))
    # the expanded index serves: both CLIs rank the same documents
    _retrieve_matches(str(index_chain / "port2.npz"),
                      index_chain / "run", ["--packed"])


def test_cli_index_refuses_bert_ckpt(tmp_path):
    """A directory that is not a HuggingFace checkpoint is named before the
    corpus is read."""
    args = port_cli.build_parser().parse_args(
        ["index", "--corpus", str(tmp_path / "none.tsv"), "--out",
         str(tmp_path / "x.npz"), "--bert-ckpt", str(tmp_path), "--device",
         "cpu"])
    with pytest.raises(FileNotFoundError,
                       match=re.escape(f"{tmp_path}: no config.json")):
        args.fn(args)


@pytest.mark.parametrize("cmd", ["index", "expand"])
def test_cli_index_and_expand_refuse_cuda_without_a_card(cmd, index_chain):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [cmd, "--corpus", str(index_chain / "new.tsv"), "--out",
            str(index_chain / "never.npz"), *TOWER_FLAGS]
    if cmd == "expand":
        argv += ["--index", str(index_chain / "port.npz")]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "gdr_tpu_torch.cli", *argv],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (index_chain / "never.npz").exists()
