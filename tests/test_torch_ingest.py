"""``python -m gdr_tpu_torch.cli ingest`` and ``data/corpus.py`` of the port
against ``gdr_tpu``'s: on the tiny NQ fixtures (12 docs, 24 train, 6 dev
questions) and on a pickled corpus written here, both CLIs write
byte-equal ``corpus.tsv`` / ``train.tsv`` / ``dev.tsv`` and print the same
summary, and they refuse the same flag combinations."""

import dataclasses
import pickle
from pathlib import Path

import pytest

from gdr_tpu import cli as jax_cli
from gdr_tpu.data import corpus as jcorpus
from gdr_tpu_torch import cli as port_cli
from gdr_tpu_torch.data import corpus

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TRAIN = str(FIXTURES / "nq_tiny_train.jsonl.gz")
DEV = str(FIXTURES / "nq_tiny_dev.jsonl.gz")


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """A pickled corpus (a tab and a newline in its fields, quotes to
    strip) and query records whose positives include unknown titles and
    repeats, as the 334k-document pipeline's files hold them."""
    tmp = tmp_path_factory.mktemp("pickles")
    docs = [{"title": f"Doc\t{i}", "text": f'Text "{i}"\n ``about`` '
             f"topic {i % 4}  WITH  case"} for i in range(20)]
    queries = [{"query": f"Question {i}\nabout \"topic\" {i % 4}",
                "positive_passages": [{"title": f"Doc\t{(i * 7) % 20}"},
                                      {"title": "missing"},
                                      {"title": f"Doc\t{(i * 7) % 20}"},
                                      {"title": f"Doc\t{i % 3}"}]}
               for i in range(15)]
    queries.append({"query": "no known positive",
                    "positive_passages": [{"title": "missing"}]})
    files = {}
    for name, recs in (("corpus", docs), ("train", queries[:12]),
                       ("dev", queries[12:])):
        files[name] = tmp / f"{name}.pkl"
        with open(files[name], "wb") as fh:
            pickle.dump(recs, fh)
    return files


CASES = {
    "dev-jsonl": ["--nq-jsonl", TRAIN, "--dev-jsonl", DEV],
    "max-records": ["--nq-jsonl", TRAIN, "--dev-jsonl", DEV,
                    "--max-records", "10"],
    "dev-frac": ["--nq-jsonl", TRAIN, "--dev-frac", "0.25"],
    "train-only": ["--nq-jsonl", TRAIN],
    "pickle": ["--corpus-pickle", "{corpus}", "--train-pickle", "{train}",
               "--dev-pickle", "{dev}"],
    "pickle-dev-frac": ["--corpus-pickle", "{corpus}", "--train-pickle",
                        "{train}", "--dev-frac", "0.2"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_ingest_writes_the_same_tsvs_as_gdr_tpu(case, pickles, tmp_path,
                                                capsys):
    argv = [a.format(**pickles) for a in CASES[case]]
    said = {}
    for name, main in (("ref", jax_cli.main), ("port", port_cli.main)):
        main(["ingest", *argv, "--out-dir", str(tmp_path / name)])
        said[name] = capsys.readouterr().out.replace(str(tmp_path / name),
                                                     "OUT")
    assert said["port"] == said["ref"]
    ref = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ref
    assert ref[:2] == ["corpus.tsv", "dev.tsv"] or case == "train-only"
    for name in ref:
        want = (tmp_path / "ref" / name).read_bytes()
        assert want and (tmp_path / "port" / name).read_bytes() == want, name


@pytest.mark.parametrize("argv,match", [
    ([], "exactly one of"),
    (["--nq-jsonl", TRAIN, "--corpus-pickle", "c.pkl"], "exactly one of"),
    (["--corpus-pickle", "c.pkl"], "requires --train-pickle")],
    ids=["neither", "both", "no-train-pickle"])
def test_ingest_refuses_as_gdr_tpu(argv, match, tmp_path):
    for main in (jax_cli.main, port_cli.main):
        with pytest.raises(ValueError, match=match):
            main(["ingest", *argv, "--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_library_ingest_matches_gdr_tpu(pickles):
    """The entry points the CLI does not call: one jsonl file, and the
    pickle records' corpus + queries in one call."""
    for max_records in (None, 7):
        got = corpus.ingest_nq_jsonl(DEV, max_records)
        want = jcorpus.ingest_nq_jsonl(DEV, max_records)
        assert [dataclasses.asdict(x) for x in got] == \
            [dataclasses.asdict(x) for x in want]
    recs = {}
    for name in ("corpus", "train"):
        with open(pickles[name], "rb") as fh:
            recs[name] = pickle.load(fh)
    got = corpus.ingest_pickle_corpus(recs["corpus"], recs["train"])
    want = jcorpus.ingest_pickle_corpus(recs["corpus"], recs["train"])
    assert [dataclasses.asdict(x) for x in got] == \
        [dataclasses.asdict(x) for x in want]
    assert len(got[0]) == 20 and len(got[1]) == 12
