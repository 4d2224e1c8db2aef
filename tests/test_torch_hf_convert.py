"""The port's HuggingFace loaders (``gdr_tpu_torch/models/convert.py``)
against ``gdr_tpu/models/convert.py``, which reads the same directories
through ``transformers``.

Tiny T5 and BERT models with seeded weights are saved by ``save_pretrained``
in four layouts (f32 safetensors, bf16 safetensors, ``pytorch_model.bin``,
sharded safetensors).  The port's loads must be bit-equal to gdr_tpu's
taken through the weight bridge (``params_from_flax``) and to
``transformers``' own state dict of the directory; the encoder and the doc
tower on those weights agree with gdr_tpu's within 1e-5 in f32.  The
reference fork's full model loads bit-equal too, but for the adaptor's q
rows, which fold in a scale (1 ulp); its seeded state dict under the
fork's names is ``chip_smoke.fork_state_dict``, which phase 9 of the GPU
smoke test loads too.  A subprocess with ``transformers``
and ``safetensors`` blocked loads the same directories."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import fork_state_dict
from gdr_tpu.config import ModelConfig as JaxModelConfig
from gdr_tpu.models import convert as jconvert
from gdr_tpu.models.dual_encoder import DocEncoder as JaxDocEncoder
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu.models.gdr import init_params
from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.convert import doc_encoder_params_from_flax, params_from_flax
from gdr_tpu_torch.models import convert
from gdr_tpu_torch.models.dual_encoder import DocEncoder, DocEncoderConfig
from gdr_tpu_torch.models.gdr import GenerativeRetriever

ROOT = Path(__file__).resolve().parents[1]
FORMATS = ["f32", "bf16", "bin", "sharded"]
T5 = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
          num_heads=4)
BERT = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40)
TOWER = dict(vocab_size=96, d_model=32, num_layers=2, num_heads=4, d_ff=64,
             max_position=40)
TOL = 1e-5


def _save(model, path: Path, fmt: str) -> str:
    if fmt == "bf16":
        model = model.to(torch.bfloat16)
    kw = dict(safe_serialization=fmt != "bin")
    if fmt == "sharded":
        kw["max_shard_size"] = "20KB"
    model.save_pretrained(str(path), **kw)
    return str(path)


@pytest.fixture(scope="module")
def t5_dirs(tmp_path_factory):
    from transformers import T5Config, T5ForConditionalGeneration

    torch.manual_seed(0)
    cfg = T5Config(**T5, feed_forward_proj="relu", dropout_rate=0.0)
    tmp = tmp_path_factory.mktemp("hf_t5")
    return {fmt: _save(T5ForConditionalGeneration(cfg), tmp / fmt, fmt)
            for fmt in FORMATS}


@pytest.fixture(scope="module")
def bert_dirs(tmp_path_factory):
    from transformers import BertConfig, BertModel

    torch.manual_seed(1)
    cfg = BertConfig(**BERT, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    tmp = tmp_path_factory.mktemp("hf_bert")
    return {fmt: _save(BertModel(cfg), tmp / fmt, fmt) for fmt in FORMATS}


def _jax_t5():
    """(gdr_tpu's tiny retriever, its init tree, the port's retriever on the
    same init) at the T5 checkpoint's widths."""
    kw = dict(T5, num_decoder_layers=2, kary=4, max_output_length=5,
              encoder_d_model=32, adaptor_layer_num=1, adaptor_num_heads=2)
    jm = JaxRetriever(JaxModelConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jm, jax.random.PRNGKey(0), input_len=8))
    tm = GenerativeRetriever(ModelConfig(**kw))
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm.eval()


def _jax_tower():
    enc = JaxDocEncoder(**TOWER, dropout_rate=0.0)
    ids = np.zeros((2, 8), np.int32)
    params = jax.tree_util.tree_map(
        np.asarray, enc.init(jax.random.PRNGKey(0), ids, np.ones_like(ids)))
    return enc, params, DocEncoder(DocEncoderConfig(**TOWER)).eval()


def _assert_state_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _hf_state(cls_name: str, path: str) -> dict:
    import transformers
    model = getattr(transformers, cls_name).from_pretrained(path)
    return {k: v.float() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("fmt", FORMATS)
def test_t5_encoder_load_matches_gdr_tpu(t5_dirs, fmt):
    path = t5_dirs[fmt]
    jm, params, tm = _jax_t5()
    want = params_from_flax(jconvert.load_t5_encoder(
        params, jconvert.state_dict_from_pretrained(path), T5["num_layers"]))
    sd = convert.state_dict_from_pretrained(path)
    convert.load_t5_encoder(tm, sd, T5["num_layers"])
    _assert_state_equal(tm.state_dict(), want)
    # the reader gives transformers' tensors; tied duplicates are optional
    hf = _hf_state("T5ForConditionalGeneration", path)
    assert "shared.weight" in sd and set(sd) <= set(hf)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and torch.equal(v, hf[k]), k


@pytest.mark.parametrize("fmt", FORMATS)
def test_bert_tower_load_matches_gdr_tpu(bert_dirs, fmt):
    path = bert_dirs[fmt]
    _, params, tower = _jax_tower()
    want = doc_encoder_params_from_flax(jconvert.load_bert_encoder(
        params, jconvert.bert_state_dict_from_pretrained(path),
        TOWER["num_layers"], TOWER["num_heads"]))
    sd = convert.bert_state_dict_from_pretrained(path)
    convert.load_bert_encoder(tower, sd)
    _assert_state_equal(tower.state_dict(), want)
    hf = _hf_state("BertModel", path)
    assert set(sd) <= set(hf)
    for k, v in sd.items():
        assert torch.equal(v, hf[k]), k


@pytest.mark.parametrize("fmt", FORMATS)
def test_encoder_and_tower_forward_match_gdr_tpu(t5_dirs, bert_dirs, fmt):
    jm, params, tm = _jax_t5()
    loaded = jconvert.load_t5_encoder(
        params, jconvert.state_dict_from_pretrained(t5_dirs[fmt]),
        T5["num_layers"])
    convert.load_t5_encoder(tm, convert.state_dict_from_pretrained(
        t5_dirs[fmt]), T5["num_layers"])
    rng = np.random.default_rng(2)
    ids = rng.integers(2, T5["vocab_size"], size=(3, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, loaded),
                               jnp.asarray(ids), jnp.asarray(mask),
                               method=jm.encode))
    with torch.no_grad():
        got = tm.encode(torch.as_tensor(ids), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)

    enc, bparams, tower = _jax_tower()
    bloaded = jconvert.load_bert_encoder(
        bparams, jconvert.bert_state_dict_from_pretrained(bert_dirs[fmt]),
        TOWER["num_layers"], TOWER["num_heads"])
    convert.load_bert_encoder(tower, convert.bert_state_dict_from_pretrained(
        bert_dirs[fmt]))
    ids = rng.integers(1, TOWER["vocab_size"], size=(4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 5:] = 0
    want = np.asarray(enc.apply(bloaded, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tower(torch.as_tensor(ids), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _bert_variant(bert_dirs, tmp_path: Path, kind: str) -> str:
    """The f32 BERT checkpoint rewritten as ``kind``: legacy LayerNorm
    gamma / beta names in a .bin, BertForPreTraining's ``bert.`` prefix with
    its ``cls.*`` heads, or DPR's ``ctx_encoder.bert_model.`` prefix."""
    import transformers

    base = transformers.BertModel.from_pretrained(bert_dirs["f32"])
    out = tmp_path / kind
    if kind == "legacy":
        sd = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
              .replace("LayerNorm.bias", "LayerNorm.beta"): v
              for k, v in base.state_dict().items()}
        assert any(k.endswith("gamma") for k in sd)
        out.mkdir()
        base.config.save_pretrained(str(out))
        torch.save(sd, out / "pytorch_model.bin")
    elif kind == "bert-prefix":
        m = transformers.BertForPreTraining(base.config)
        m.bert.load_state_dict(base.state_dict())
        m.save_pretrained(str(out))
    else:
        cfg = transformers.DPRConfig(**BERT)
        m = transformers.DPRContextEncoder(cfg)
        m.ctx_encoder.bert_model.load_state_dict(base.state_dict(),
                                                 strict=False)
        m.save_pretrained(str(out))
    return str(out)


@pytest.mark.parametrize("kind", ["legacy", "bert-prefix", "dpr-prefix"])
def test_bert_variants_load_the_same_tower(bert_dirs, tmp_path, kind):
    path = _bert_variant(bert_dirs, tmp_path, kind)
    want = convert.load_bert_encoder(
        DocEncoder(DocEncoderConfig(**TOWER)),
        convert.bert_state_dict_from_pretrained(bert_dirs["f32"]))
    got = convert.load_bert_encoder(
        DocEncoder(DocEncoderConfig(**TOWER)),
        convert.bert_state_dict_from_pretrained(path))
    _assert_state_equal(got.state_dict(), want.state_dict())
    assert convert.bert_model_overrides(path) == TOWER


@pytest.mark.parametrize("kind,config", [
    ("t5", {"model_type": "t5"}),
    ("t5", {"model_type": "t5", "d_model": 48, "num_layers": 3,
            "vocab_size": 100}),
    ("t5", {"model_type": "t5", "hidden_size": 40, "num_hidden_layers": 5,
            "num_attention_heads": 5, "head_dim": 8, "d_ff": 80}),
    ("bert", {"model_type": "bert"}),
    ("bert", {"model_type": "bert", "hidden_size": 48,
              "num_hidden_layers": 3, "max_position_embeddings": 64})],
    ids=["t5-defaults", "t5-some", "t5-aliases", "bert-defaults",
         "bert-some"])
def test_overrides_match_gdr_tpu(tmp_path, kind, config):
    """config.json files that leave fields at their class defaults."""
    (tmp_path / "config.json").write_text(json.dumps(config))
    got = getattr(convert, f"{kind}_model_overrides")(str(tmp_path))
    want = getattr(jconvert, f"{kind}_model_overrides")(str(tmp_path))
    assert got == want


def test_save_pretrained_config_overrides(t5_dirs, bert_dirs):
    assert convert.t5_model_overrides(t5_dirs["bin"]) == \
        jconvert.t5_model_overrides(t5_dirs["bin"]) == T5
    assert convert.bert_model_overrides(bert_dirs["sharded"]) == TOWER


def test_gated_gelu_checkpoint_raises_on_wi(tmp_path):
    from transformers import T5Config, T5ForConditionalGeneration

    torch.manual_seed(3)
    path = _save(T5ForConditionalGeneration(
        T5Config(**T5, feed_forward_proj="gated-gelu")), tmp_path / "gg",
        "f32")
    wi = "encoder.block.0.layer.1.DenseReluDense.wi.weight"
    jm, params, tm = _jax_t5()
    with pytest.raises(KeyError, match=wi):
        jconvert.load_t5_encoder(
            params, jconvert.state_dict_from_pretrained(path),
            T5["num_layers"])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with pytest.raises(KeyError, match=wi):
        convert.load_t5_encoder(tm, convert.state_dict_from_pretrained(path),
                                T5["num_layers"])
    _assert_state_equal(tm.state_dict(), before)     # nothing was copied


def test_export_t5_encoder_matches_gdr_tpu(t5_dirs, tmp_path):
    jm, params, tm = _jax_t5()
    sd = convert.state_dict_from_pretrained(t5_dirs["f32"])
    convert.load_t5_encoder(tm, sd, T5["num_layers"])
    want = jconvert.export_t5_encoder(
        jconvert.load_t5_encoder(params, jconvert.state_dict_from_pretrained(
            t5_dirs["f32"]), T5["num_layers"]), T5["num_layers"])
    got = convert.export_t5_encoder(tm.state_dict(), T5["num_layers"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], sd[k].numpy())
    np.savez(tmp_path / "dump.npz", **got)
    back = convert.state_dict_from_pretrained(str(tmp_path / "dump.npz"))
    fresh = _jax_t5()[2]
    convert.load_t5_encoder(fresh, back, T5["num_layers"])
    _assert_state_equal(fresh.state_dict(), tm.state_dict())


# ------------------------------------------------------------ the fork

REF = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2,
           num_decoder_layers=2, num_heads=4, kary=5, max_output_length=4,
           encoder_d_model=32, adaptor_layer_num=2, adaptor_num_heads=8,
           adaptor_d_ff=40)


def _fork_pair(**overrides):
    kw = {**REF, **overrides}
    jm = JaxRetriever(JaxModelConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jm, jax.random.PRNGKey(4), input_len=8))
    tm = GenerativeRetriever(ModelConfig(**kw))
    tm.load_state_dict(params_from_flax(params))
    return kw, params, tm


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_load_gdr_reference_matches_gdr_tpu(tied):
    kw, params, tm = _fork_pair(tie_decode_embedding=tied)
    sd = fork_state_dict(ModelConfig(**kw), 5)
    want = params_from_flax(jconvert.load_gdr_reference(
        params, sd, kw["num_layers"], kw["num_decoder_layers"],
        kw["adaptor_layer_num"], kw["adaptor_num_heads"]))
    convert.load_gdr_reference(tm, {k: torch.from_numpy(v)
                                    for k, v in sd.items()})
    got = tm.state_dict()
    assert got.keys() == want.keys() and ("lm_head" in got) != tied
    d = kw["d_model"]
    for k in want:
        if k.startswith("pawa.layers.") and k.endswith("qkv.weight"):
            # the q rows fold in head_dim**-0.5: at most 1 ulp apart
            g, w = got[k][:d].numpy(), want[k][:d].numpy()
            assert np.abs(g.view(np.int32) - w.view(np.int32)).max() <= 1, k
            assert torch.equal(got[k][d:], want[k][d:]), k
        else:
            assert torch.equal(got[k], want[k]), k


def test_load_gdr_reference_refuses_adaptor_biases():
    kw, _, tm = _fork_pair()
    sd = fork_state_dict(ModelConfig(**kw), 6)
    sd["adaptor.layers.1.linear1.bias"][3] = 0.5
    with pytest.raises(ValueError, match="linear1.bias must be zero"):
        convert.load_gdr_reference(tm, sd)


# ------------------------------------------------------------ the reader

def test_safetensors_reader_refuses_a_bad_file(tmp_path):
    header = json.dumps({"a": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 12]}}).encode()
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(16))
    with pytest.raises(ValueError, match="offsets 0..12"):
        convert.read_safetensors(str(bad))
    header = json.dumps({"a": {"dtype": "F64", "shape": [1],
                               "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="dtype F64"):
        convert.read_safetensors(str(bad))
    with pytest.raises(FileNotFoundError, match="config.json"):
        convert.t5_model_overrides(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        convert.read_state_dict(str(tmp_path))


def test_chip_smoke_checkpoint_writer_reads_back(tmp_path):
    """The directories chip_smoke.py writes by hand, without
    transformers: safetensors' own reader and transformers agree with the
    port on them."""
    import chip_smoke
    from safetensors.torch import load_file

    rng = np.random.default_rng(7)
    tensors = {"a.weight": torch.as_tensor(rng.normal(size=(3, 5)),
                                           dtype=torch.float32),
               "b": torch.as_tensor(rng.normal(size=(7,)),
                                    dtype=torch.bfloat16),
               "c": torch.arange(5, dtype=torch.int64)}
    chip_smoke.write_safetensors(tmp_path / "x.safetensors", tensors)
    got = convert.read_safetensors(str(tmp_path / "x.safetensors"))
    want = load_file(str(tmp_path / "x.safetensors"))
    assert got.keys() == want.keys() == tensors.keys()
    for k in tensors:
        assert torch.equal(want[k], tensors[k])
        assert torch.equal(got[k], tensors[k].float())

    from transformers import T5ForConditionalGeneration
    path = tmp_path / "t5"
    sd = chip_smoke.write_t5_checkpoint(path, dict(T5), seed=0,
                                        fmt="safetensors")
    hf = T5ForConditionalGeneration.from_pretrained(str(path)).state_dict()
    got = convert.state_dict_from_pretrained(str(path))
    assert convert.t5_model_overrides(str(path)) == T5
    for k, v in sd.items():
        assert torch.equal(got[k], v) and torch.equal(hf[k], v), k


def test_loaders_work_without_transformers(t5_dirs, bert_dirs, tmp_path):
    code = (
        "import sys, torch\n"
        "sys.modules['transformers'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "from gdr_tpu_torch.models import convert\n"
        "out = {}\n"
        f"for fmt, t5, bert in {[(f, t5_dirs[f], bert_dirs[f]) for f in FORMATS]!r}:\n"
        "    out[f't5/{fmt}'] = convert.state_dict_from_pretrained(t5)\n"
        "    out[f'bert/{fmt}'] = convert.bert_state_dict_from_pretrained(bert)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('transformers', 'safetensors', 'jax', 'gdr_tpu')\n"
        "             and sys.modules[k] is not None)\n"
        "assert not bad, bad\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    for fmt in FORMATS:
        _assert_state_equal(got[f"t5/{fmt}"],
                            convert.state_dict_from_pretrained(t5_dirs[fmt]))
        _assert_state_equal(got[f"bert/{fmt}"],
                            convert.read_state_dict(bert_dirs[fmt]))
