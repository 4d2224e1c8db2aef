"""Pretrained starts through the port's CLI on the CPU, against ``gdr_tpu``:
``index --bert-ckpt`` embeds a corpus with a HuggingFace BERT directory as
``gdr_tpu``'s CLI does (the same store within 1e-5, the trie ``gdr_tpu``
builds from it); ``train --t5-ckpt`` warm-starts the encoder and shared
embeddings from a HuggingFace T5 directory or from ``gdr_tpu``'s
``export_t5_encoder`` dump, and leaves every other parameter at the
seeded init; ``train --bert-ckpt`` starts the stage-2 tower from the BERT
directory; and the refusals of the reference (vocab and width mismatches,
``--bert-ckpt`` without stage 2, an unknown ``.npz``)."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gdr_tpu import cli as jax_cli
from gdr_tpu.config import IndexConfig as JaxIndexConfig
from gdr_tpu.index.builder import build_index_from_embeddings
from gdr_tpu.index.io import load_index as jax_load_index
from gdr_tpu.models import convert as jconvert
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu.models.gdr import init_params
from gdr_tpu_torch import cli as port_cli
from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.convert import (load_params_npz, params_from_flax,
                                   params_to_flax)
from gdr_tpu_torch.index.io import load_index
from gdr_tpu_torch.models import convert
from gdr_tpu_torch.models.dual_encoder import DocEncoder, DocEncoderConfig
from gdr_tpu_torch.models.gdr import GenerativeRetriever
from gdr_tpu_torch.train.checkpoint import CheckpointManager

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega").split()
# the tiny preset's encoder widths, so a cold run builds the same model
T5 = dict(vocab_size=32128, d_model=64, d_kv=16, d_ff=128, num_layers=2,
          num_heads=4)
MODEL = ["--model-size", "tiny", "--kary", "4", "--max-output-length", "5",
         "--adaptor-layers", "1", "--beam", "6", "--max-input-length", "12",
         "--device", "cpu"]
TOWER = ["--encoder-size", "tiny", "--encoder-max-len", "16"]
WARM = ("shared.", "encoder.")


def _bert_dir(path: Path, hidden: int, seed: int) -> str:
    from transformers import BertConfig, BertModel

    torch.manual_seed(seed)
    BertModel(BertConfig(vocab_size=512, hidden_size=hidden,
                         num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=64)
              ).save_pretrained(str(path), safe_serialization=False)
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from transformers import T5Config, T5ForConditionalGeneration

    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("torch_cli_pretrained")
    rng = np.random.default_rng(0)
    n = 40
    (tmp / "docs.tsv").write_text("".join(
        f"doc {i}\t{' '.join(rng.choice(WORDS, int(rng.integers(4, 14))))}\n"
        for i in range(n)))
    (tmp / "train.tsv").write_text("".join(
        f"{' '.join(rng.choice(WORDS, 4))}\t{int(rng.integers(0, n))}\n"
        for _ in range(24)))
    torch.manual_seed(1)
    T5ForConditionalGeneration(T5Config(**T5, feed_forward_proj="relu")
                               ).save_pretrained(str(tmp / "t5"))
    bert = _bert_dir(tmp / "bert", 32, 2)
    index = ["--corpus", str(tmp / "docs.tsv"), "--kary", "4", "--leaf-cap",
             "8", "--encoder-max-len", "16", "--bert-ckpt", bert,
             "--batch-size", "16"]
    port_cli.main(["index", *index, "--out", str(tmp / "port.npz"),
                   "--device", "cpu"])
    jax_cli.main(["index", *index, "--out", str(tmp / "ref.npz")])
    common = ["--index", str(tmp / "port.npz"), "--train",
              str(tmp / "train.tsv"), "--dev", str(tmp / "train.tsv"),
              *MODEL]
    port_cli.main(["train", *common, "--workdir", str(tmp / "cold"),
                   "--epochs", "0"])
    return tmp, common


def test_index_bert_ckpt_matches_gdr_tpu_cli(world):
    tmp, _ = world
    port = load_index(str(tmp / "port.npz"))
    ref = jax_load_index(str(tmp / "ref.npz"))
    assert port.store.shape == ref.store.shape == (40, 32)
    np.testing.assert_allclose(port.store, ref.store, rtol=0, atol=1e-5)
    want = build_index_from_embeddings(port.store, JaxIndexConfig(
        kary=4, leaf_cap=8, seed=7, embedding_dim=32))
    for f in ("children", "depth", "cluster_docs", "doc_indices"):
        np.testing.assert_array_equal(getattr(port.trie, f),
                                      getattr(want.trie, f), err_msg=f)
    assert port.paths == want.paths


def _export_dump(path: Path) -> dict:
    """gdr_tpu's export_t5_encoder of a seeded tiny tree: the HF-named
    ``.npz`` its ``train --t5-ckpt`` reads."""
    from gdr_tpu.config import ModelConfig as JaxModelConfig

    mcfg = JaxModelConfig().scaled("tiny")
    params = init_params(JaxRetriever(mcfg), jax.random.PRNGKey(9),
                         input_len=8)
    sd = jconvert.export_t5_encoder(params, mcfg.num_layers)
    np.savez(path, **sd)
    return sd


@pytest.mark.parametrize("source", ["hf-dir", "export-npz"])
def test_train_t5_ckpt_warm_starts_encoder_and_shared(world, source,
                                                      tmp_path):
    tmp, common = world
    if source == "hf-dir":
        ckpt = str(tmp / "t5")
    else:
        ckpt = str(tmp_path / "dump.npz")
        _export_dump(ckpt)
    port_cli.main(["train", *common, "--workdir", str(tmp_path / "warm"),
                   "--epochs", "0", "--t5-ckpt", ckpt])
    got = load_params_npz(str(tmp_path / "warm" / "params.npz"))
    cold = load_params_npz(str(tmp / "cold" / "params.npz"))
    # the port's loader on the seeded init is what train must have written
    model = GenerativeRetriever(dataclasses.replace(
        ModelConfig().scaled("tiny"), kary=4, max_output_length=5,
        adaptor_layer_num=1, encoder_d_model=32))
    model.load_state_dict(cold)
    convert.load_t5_encoder(model, convert.state_dict_from_pretrained(ckpt),
                            T5["num_layers"])
    want = model.state_dict()
    assert got.keys() == want.keys() == cold.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert k.startswith(WARM) or torch.equal(got[k], cold[k]), k
    for k in ("shared.weight", "encoder.blocks.1.attn.qkv.weight"):
        assert not torch.equal(got[k], cold[k]), k
    # and gdr_tpu's loader puts the same tensors there
    ref = jconvert.load_t5_encoder(params_to_flax(cold),
                                   jconvert.state_dict_from_pretrained(ckpt),
                                   T5["num_layers"])
    for k, v in params_from_flax(ref).items():
        assert torch.equal(got[k], v), k


def test_train_bert_ckpt_starts_the_stage2_tower(world, tmp_path):
    """At learning rate 0 the trained tower stays the checkpoint's."""
    tmp, common = world
    port_cli.main(["train", *common, "--workdir", str(tmp_path / "run"),
                   "--epochs", "1", "--train-encoder-epoch", "0",
                   "--batch-size", "8", "--lr", "0", "--decoder-lr", "0",
                   "--corpus", str(tmp / "docs.tsv"), "--encoder-max-len",
                   "16", "--bert-ckpt", str(tmp / "bert")])
    step, state = CheckpointManager(str(tmp_path / "run" / "ckpt")
                                    ).restore_best()
    assert step is not None
    want = convert.load_bert_encoder(
        DocEncoder(DocEncoderConfig(**convert.bert_model_overrides(
            str(tmp / "bert")))),
        convert.bert_state_dict_from_pretrained(str(tmp / "bert")))
    got = state.params["doc_encoder"]
    assert got.keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k


def test_train_refuses_what_the_reference_refuses(world, tmp_path):
    tmp, common = world
    run = ["train", *common, "--workdir", str(tmp_path), "--epochs", "1"]
    stage2 = ["--corpus", str(tmp / "docs.tsv"), "--train-encoder-epoch",
              "0", *TOWER]
    tok = tmp_path / "tok.json"
    port_cli.main(["tokenizer", "--corpus", str(tmp / "docs.tsv"), "--out",
                   str(tok), "--vocab-size", "60"])
    with pytest.raises(ValueError, match="must match the --t5-ckpt vocab"):
        port_cli.main([*run, "--t5-ckpt", str(tmp / "t5"), "--tokenizer",
                       str(tok)])
    with pytest.raises(ValueError, match="warm-starts the stage-2 doc tower"):
        port_cli.main([*run, "--bert-ckpt", str(tmp / "bert")])
    wide = _bert_dir(tmp_path / "bert48", 48, 3)
    with pytest.raises(ValueError, match=r"hidden size \(48\) != index store "
                                         r"dim \(32\)"):
        port_cli.main([*run, *stage2, "--bert-ckpt", wide])
    with pytest.raises(ValueError, match="must match the --bert-ckpt vocab"):
        port_cli.main([*run, *stage2, "--bert-ckpt", str(tmp / "bert"),
                       "--doc-tokenizer", str(tok)])
    np.savez(tmp_path / "other.npz", weights=np.zeros(3, np.float32))
    with pytest.raises(SystemExit, match="neither an export_t5_encoder"):
        port_cli.main([*run, "--t5-ckpt", str(tmp_path / "other.npz")])
