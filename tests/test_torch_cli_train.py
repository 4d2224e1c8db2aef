"""``python -m gdr_tpu_torch.cli train`` on the CPU: ``index`` → ``train``
(a tiny model, two epochs, the live doc tower from epoch 1, BM25 hard
negatives, the gtq + doc query mix) → ``eval`` of the ``params.npz`` it
wrote, which holds the best checkpoint's masters; the ``--t5-ckpt``
warm start from a ``params.npz``; the secondary modes, qg queries,
pretrained checkpoints and ``--mesh auto`` in one process getting as far
as reading the index; and ``--device cuda`` without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gdr_tpu_torch import cli as port_cli
from gdr_tpu_torch.convert import load_params_npz
from gdr_tpu_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega").split()
MODEL = ["--model-size", "tiny", "--kary", "4", "--max-output-length", "5",
         "--adaptor-layers", "1", "--beam", "6", "--max-input-length", "12"]
TOWER = ["--encoder-size", "tiny", "--encoder-max-len", "16"]


def _cli(argv, ok: bool = True) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "gdr_tpu_torch.cli", *argv],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert (out.returncode == 0) == ok, out.stderr
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_train")
    rng = np.random.default_rng(0)
    n = 60
    (tmp / "docs.tsv").write_text("".join(
        f"doc {i}\t{' '.join(rng.choice(WORDS, int(rng.integers(4, 14))))}\n"
        for i in range(n)))
    for name, q in (("train.tsv", 40), ("dev.tsv", 8)):
        (tmp / name).write_text("".join(
            f"{' '.join(rng.choice(WORDS, 4))}\t{int(rng.integers(0, n))}\n"
            for _ in range(q)))
    _cli(["index", "--corpus", str(tmp / "docs.tsv"), "--out",
          str(tmp / "index.npz"), "--kary", "4", "--leaf-cap", "8", *TOWER,
          "--device", "cpu"])
    common = ["--index", str(tmp / "index.npz"), "--dev",
              str(tmp / "dev.tsv"), *MODEL, "--device", "cpu"]
    train = _cli(["train", *common, "--train", str(tmp / "train.tsv"),
                  "--workdir", str(tmp / "run"), "--batch-size", "8",
                  "--epochs", "2", "--train-encoder-epoch", "0", "--corpus",
                  str(tmp / "docs.tsv"), *TOWER, "--hard-negatives", "bm25",
                  "--query-type", "gtq_doc", "--packed-eval"])
    ev = _cli(["eval", *common, "--workdir", str(tmp / "run"), "--packed"])
    return tmp, common, train, ev


def test_train_then_eval_reads_its_params(run):
    tmp, _, train, ev = run
    assert "stage 2 enabled" in train.stderr
    assert "40 gtq + 60 doc = 100 rows" in train.stderr
    assert "recall1" in json.loads(train.stdout.splitlines()[-1])
    assert f"loaded {tmp / 'run' / 'params.npz'}" in ev.stderr
    metrics = json.loads(ev.stdout)
    assert 0.0 <= metrics["recall1"] <= 1.0


def test_params_npz_holds_the_best_checkpoint(run):
    tmp = run[0]
    step, state = CheckpointManager(str(tmp / "run" / "ckpt")).restore_best()
    assert step is not None
    got = load_params_npz(str(tmp / "run" / "params.npz"))
    want = state.params["generator"]
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_t5_ckpt_npz_warm_starts_encoder_and_shared(run):
    tmp, common, _, _ = run
    _cli(["train", *common, "--train", str(tmp / "train.tsv"), "--workdir",
          str(tmp / "warm"), "--epochs", "0", "--seed", "5", "--t5-ckpt",
          str(tmp / "run" / "params.npz")])
    src = load_params_npz(str(tmp / "run" / "params.npz"))
    got = load_params_npz(str(tmp / "warm" / "params.npz"))
    for k in src:
        same = torch.equal(got[k], src[k])
        assert same == k.startswith(("shared.", "encoder.")), k


@pytest.mark.parametrize("flags", [
    ["--ensemble", "2"], ["--hierarchic"], ["--softmax"], ["--qg", "q.npz"],
    ["--query-type", "gtq_qg"], ["--t5-ckpt", "t5-base"],
    ["--bert-ckpt", "bert"], ["--mesh", "auto"]],
    ids=lambda f: " ".join(f))
def test_train_refuses_what_is_not_ported(flags, tmp_path):
    """The secondary modes, qg queries and ``--mesh auto`` in one process
    (no process group: the one-process path, no mesh) get as far as
    reading the (missing) index; qg queries without the ``qg``
    subcommand's .npz are refused; a HuggingFace checkpoint is read before
    the index, so a missing one is named."""
    args = port_cli.build_parser().parse_args(
        ["train", "--index", str(tmp_path / "none.npz"), "--train",
         str(tmp_path / "t.tsv"), "--dev", str(tmp_path / "d.tsv"),
         "--workdir", str(tmp_path), "--device", "cpu", *flags])
    if flags[0] in ("--ensemble", "--hierarchic", "--softmax", "--qg",
                    "--mesh"):
        with pytest.raises(FileNotFoundError, match="none.npz"):
            args.fn(args)
        if flags[0] == "--mesh":
            assert port_cli._train_mesh("auto", "cpu", (8, 8)) is None
    elif flags[0] in ("--t5-ckpt", "--bert-ckpt"):
        with pytest.raises(FileNotFoundError,
                           match=f"{flags[1]}: no config.json"):
            args.fn(args)
    else:
        with pytest.raises(SystemExit, match="needs --qg"):
            args.fn(args)


def test_train_refuses_cuda_without_a_card(run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, common, _, _ = run
    argv = [a if a != "cpu" else "cuda" for a in common]
    out = _cli(["train", *argv, "--train", str(tmp / "train.tsv"),
                "--workdir", str(tmp_path)], ok=False)
    assert "CUDA is not available" in out.stderr
