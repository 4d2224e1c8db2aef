"""The port's CLI for query generation and the secondary modes, on the CPU
over a tiny world (``index`` of 60 docs): ``qg`` → ``train --qg`` (the
pseudo-queries join the train set), ``train --ensemble 2`` → ``eval
--ensemble 2`` (the eval reads the state files the training wrote),
``train --hierarchic`` and ``train --softmax`` (their metrics, and state
files that load into the port's modules), and ``qg`` on ``cuda`` without a
card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.convert import (hierarchic_from_flax, load_tree_npz,
                                   params_from_flax)
from gdr_tpu_torch.index.io import load_index
from gdr_tpu_torch.models.classifier import EncoderClassifier
from gdr_tpu_torch.models.hierarchic import Hierarchic
from gdr_tpu_torch.train.modes import array_to_paths, load_ensemble

ROOT = Path(__file__).resolve().parents[1]
WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega").split()
N_DOCS, N_TRAIN = 60, 40
MODEL = ["--model-size", "tiny", "--kary", "4", "--max-output-length", "5",
         "--adaptor-layers", "1"]
QG = [*MODEL, "--doc-length", "12", "--max-query-length", "20",
      "--n-per-doc", "2", "--batch-size", "16", "--device", "cpu"]


def _cli(argv, ok: bool = True) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "gdr_tpu_torch.cli", *argv],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert (out.returncode == 0) == ok, out.stderr
    return out


def _json(out: subprocess.CompletedProcess) -> dict:
    return json.loads(out.stdout[out.stdout.index("{"):])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_modes")
    rng = np.random.default_rng(0)
    (tmp / "docs.tsv").write_text("".join(
        f"doc {i}\t{' '.join(rng.choice(WORDS, int(rng.integers(4, 14))))}\n"
        for i in range(N_DOCS)))
    for name, q in (("train.tsv", N_TRAIN), ("dev.tsv", 10)):
        (tmp / name).write_text("".join(
            f"{' '.join(rng.choice(WORDS, 4))}\t"
            f"{int(rng.integers(0, N_DOCS))}\n" for _ in range(q)))
    _cli(["index", "--corpus", str(tmp / "docs.tsv"), "--out",
          str(tmp / "index.npz"), "--kary", "4", "--leaf-cap", "8",
          "--encoder-size", "tiny", "--encoder-max-len", "16",
          "--device", "cpu"])
    common = ["--index", str(tmp / "index.npz"), "--dev",
              str(tmp / "dev.tsv"), *MODEL, "--beam", "6",
              "--max-input-length", "12", "--device", "cpu"]
    return tmp, common


def test_qg_then_train_merges_the_pseudo_queries(world):
    tmp, common = world
    out = _cli(["qg", "--corpus", str(tmp / "docs.tsv"), "--out",
                str(tmp / "qg.npz"), "--train", str(tmp / "train.tsv"),
                "--qg-epochs", "1", *QG])
    assert "qg epoch 0" in out.stderr
    assert f"{2 * N_DOCS} pseudo-queries" in out.stdout
    with np.load(tmp / "qg.npz") as z:
        toks, mask, src = z["query_tokens"], z["query_mask"], z["source_doc"]
    assert toks.shape == (2 * N_DOCS, 20) and toks.dtype == np.int32
    np.testing.assert_array_equal(mask, (toks != 0).astype(np.int32))
    np.testing.assert_array_equal(src, np.repeat(np.arange(N_DOCS), 2))
    for row in toks:                         # PAD after the first EOS
        eos = np.flatnonzero(row == 1)
        if len(eos):
            assert (row[eos[0] + 1:] == 0).all()
    rows = f"{N_TRAIN} gtq + {2 * N_DOCS} qg = {N_TRAIN + 2 * N_DOCS} rows"
    for extra in ([], ["--query-type", "gtq_qg"]):
        tr = _cli(["train", *common, "--train", str(tmp / "train.tsv"),
                   "--workdir", str(tmp / "run_qg"), "--batch-size", "8",
                   "--epochs", "1", "--qg", str(tmp / "qg.npz"), *extra])
        assert rows in tr.stderr


def test_train_refuses_qg_queries_without_the_npz(world):
    tmp, common = world
    out = _cli(["train", *common, "--train", str(tmp / "train.tsv"),
                "--workdir", str(tmp / "none"), "--query-type", "gtq_qg"],
               ok=False)
    assert "needs --qg" in out.stderr


def test_ensemble_train_then_eval(world):
    tmp, common = world
    work = tmp / "run_ens"
    tr = _cli(["train", *common, "--train", str(tmp / "train.tsv"),
               "--workdir", str(work), "--batch-size", "8", "--epochs", "2",
               "--ensemble", "2"])
    assert "ensemble epoch 1" in tr.stdout
    trained = _json(tr)
    ev = _cli(["eval", *common, "--workdir", str(work), "--ensemble", "2"])
    assert _json(ev) == trained
    assert {"recall1", "recall100", "MRR10", "MAP100"} <= set(trained)
    paths = array_to_paths(np.load(work / "ensemble_paths.npy"))
    assert len(paths) == 2 and paths[0] == load_index(
        str(tmp / "index.npz")).paths
    mcfg = ModelConfig(kary=4, max_output_length=5, adaptor_layer_num=1,
                       encoder_d_model=32).scaled("tiny")
    ens = load_ensemble(mcfg, str(work), 2, device="cpu")
    assert ens.members[1].encoder is ens.members[0].encoder


def test_hierarchic_trains_and_writes_its_state(world):
    tmp, common = world
    work = tmp / "run_h"
    out = _json(_cli(["train", *common, "--train", str(tmp / "train.tsv"),
                      "--workdir", str(work), "--batch-size", "8",
                      "--epochs", "2", "--hierarchic"]))
    assert np.isfinite(out["final_loss"])
    assert {"cluster_recall1", "recall1", "cluster_MRR10", "MAP10"} <= set(out)
    sd = hierarchic_from_flax(load_tree_npz(str(work / "hierarchic.npz")))
    depth = int(load_index(str(tmp / "index.npz")).trie.depth.max())
    mcfg = ModelConfig(kary=4, max_output_length=5, adaptor_layer_num=1,
                       encoder_d_model=32).scaled("tiny")
    Hierarchic(mcfg, depth).load_state_dict(sd)


def test_softmax_trains_and_writes_its_state(world):
    tmp, common = world
    work = tmp / "run_s"
    out = _json(_cli(["train", *common, "--train", str(tmp / "train.tsv"),
                      "--workdir", str(work), "--batch-size", "8",
                      "--epochs", "2", "--softmax"]))
    assert np.isfinite(out["final_loss"])
    assert {"cluster_recall1", "cluster_recall100", "cluster_MAP100"} <= \
        set(out)
    sd = params_from_flax(load_tree_npz(str(work / "softmax.npz")))
    n_cls = load_index(str(tmp / "index.npz")).trie.num_clusters
    mcfg = ModelConfig().scaled("tiny")
    EncoderClassifier(mcfg, n_cls).load_state_dict(sd)


def test_qg_refuses_cuda_without_a_card(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, _ = world
    argv = [a if a != "cpu" else "cuda" for a in QG]
    out = _cli(["qg", "--corpus", str(tmp / "docs.tsv"), "--out",
                str(tmp / "none.npz"), *argv], ok=False)
    assert "CUDA is not available" in out.stderr
