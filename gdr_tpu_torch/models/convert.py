"""Pretrained-weight import: HuggingFace checkpoint directories → the port's
modules, read without ``transformers`` or ``safetensors``.

A counterpart of ``gdr_tpu/models/convert.py``.  GDR warm-starts from
t5-base by copying the pretrained encoder and shared-embedding tensors into
its own model (the decoder side — decode vocabulary, PAWA — trains from
scratch), and its document tower is a BERT/DPR context encoder.

A checkpoint directory holds ``config.json`` and its tensors as
``model.safetensors``, ``pytorch_model.bin`` or shards of either listed by
an ``*.index.json`` ``weight_map``.  :func:`read_state_dict` reads any of
them as f32 tensors on the host, with the load-time fix ``transformers``
makes for these checkpoints (legacy ``LayerNorm.gamma`` / ``.beta`` names
become ``.weight`` / ``.bias``).  Tied duplicates are not needed: a T5 file
keeps ``shared.weight`` and drops ``encoder.embed_tokens.weight``.

The port's layouts are torch's, so HF's ``[out, in]`` weights copy as they
are; only T5 attention differs: the port keeps one fused ``qkv`` weight
``[3·inner, d]`` (rows q | k | v), so HF's q, k and v stack into it.  The
loaders copy into a module's parameters in place, and check every name and
shape before they copy anything.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

from gdr_tpu_torch.models.t5 import is_sparse

CONFIG = "config.json"
# in the order transformers prefers them
WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json",
                "pytorch_model.bin", "pytorch_model.bin.index.json")
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64}


# ------------------------------------------------------------ the files

def read_config(path: str) -> dict:
    """``config.json`` of a checkpoint directory."""
    f = os.path.join(path, CONFIG)
    if not os.path.isfile(f):
        raise FileNotFoundError(f"{path}: no {CONFIG} (not a HuggingFace "
                                f"checkpoint directory)")
    with open(f) as fh:
        return json.load(fh)


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as f32.  The file is an
    8-byte little-endian header length, a JSON header (name → dtype, shape,
    [start, end) byte offsets into the data that follows) and the data."""
    with open(path, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        if fh.readinto(data) != len(data):
            raise ValueError(f"{path}: truncated")
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}; "
                             f"read are {sorted(_SAFETENSORS_DTYPES)}")
        start, end = meta["data_offsets"]
        count = int(np.prod(meta["shape"], dtype=np.int64))
        if end - start != count * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: {name}'s offsets {start}..{end} do not "
                             f"hold a {meta['dtype']} tensor of shape "
                             f"{meta['shape']}")
        t = (torch.frombuffer(data, dtype=dtype, count=count, offset=start)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(meta["shape"]).to(torch.float32, copy=True)
    return out


def _read_weights(path: str) -> dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(torch.float32) for k, v in sd.items()}


def _fix_key(key: str) -> str:
    """transformers' load-time rename of legacy LayerNorm parameters."""
    if key.endswith("LayerNorm.gamma"):
        return key[:-len("gamma")] + "weight"
    if key.endswith("LayerNorm.beta"):
        return key[:-len("beta")] + "bias"
    return key


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a checkpoint directory under the file's own names, as
    f32 on the host: ``model.safetensors``, ``pytorch_model.bin``, or the
    shards of a ``*.index.json``."""
    for name in WEIGHT_FILES:
        f = os.path.join(path, name)
        if not os.path.isfile(f):
            continue
        if name.endswith(".index.json"):
            with open(f) as fh:
                shards = dict.fromkeys(json.load(fh)["weight_map"].values())
            sd = {}
            for shard in shards:
                sd.update(_read_weights(os.path.join(path, shard)))
        else:
            sd = _read_weights(f)
        return {_fix_key(k): v for k, v in sd.items()}
    raise FileNotFoundError(f"{path}: none of {', '.join(WEIGHT_FILES)}")


# ------------------------------------------------------------ the configs

# the fields gdr_tpu reads, at their T5Config / BertConfig defaults: a
# config.json may leave out a field that equals its class's default
_T5_DEFAULTS = dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
                    num_layers=6, num_heads=8)
_T5_ALIASES = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
               "num_hidden_layers": "num_layers", "head_dim": "d_kv"}
_BERT_FIELDS = dict(vocab_size=("vocab_size", 30522),
                    d_model=("hidden_size", 768),
                    num_layers=("num_hidden_layers", 12),
                    num_heads=("num_attention_heads", 12),
                    d_ff=("intermediate_size", 3072),
                    max_position=("max_position_embeddings", 512))


def _sparse_step(c: dict, stack: str) -> int:
    """A Switch config's sparse step of ``stack``, or the one
    ``SwitchTransformersConfig`` derives from its count of sparse
    layers."""
    step = c.get(f"{stack}_sparse_step")
    if step is not None:
        return int(step)
    layers = c.get("num_layers" if stack == "encoder" else
                   "num_decoder_layers", 12)
    sparse = c.get(f"num_sparse_{stack}_layers", 3)
    return layers // sparse if sparse > 0 else layers


def t5_model_overrides(path: str) -> dict[str, int]:
    """``ModelConfig`` fields of a HF T5 checkpoint, so its encoder tensors
    fit the model exactly; a Switch Transformer's adds its experts, their
    capacity and the sparse steps."""
    c = read_config(path)
    for alias, field in _T5_ALIASES.items():     # T5Config.attribute_map
        if alias in c:
            c[field] = c[alias]
    out = {k: int(c.get(k, v)) for k, v in _T5_DEFAULTS.items()}
    if c.get("num_experts"):
        out.update(num_experts=int(c["num_experts"]),
                   expert_capacity=int(c.get("expert_capacity", 64)),
                   encoder_sparse_step=_sparse_step(c, "encoder"),
                   decoder_sparse_step=_sparse_step(c, "decoder"))
    return out


def bert_model_overrides(path: str) -> dict[str, int]:
    """``DocEncoderConfig`` fields of a HF BERT / DPR checkpoint."""
    c = read_config(path)
    return {k: int(c.get(hf, v)) for k, (hf, v) in _BERT_FIELDS.items()}


# ------------------------------------------------------------ copying

def _f32(v) -> torch.Tensor:
    """A torch tensor or numpy array as an f32 tensor on the host."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v))
    return v.detach().cpu().float()


def _part(t: torch.Tensor, block) -> torch.Tensor:
    """The part of the port's tensor ``t`` that one source tensor fills:
    all of it (None), a row block of a fused ``qkv`` weight (0, 1, 2),
    expert j of a stack (``("expert", j)``), or half h of a fused SwiGLU
    ``wi`` (gate rows, then up rows), of an expert's (``("expert", j,
    h)``) or of a whole tensor's (``("half", h)``)."""
    if block is None:
        return t
    if isinstance(block, tuple):
        if block[0] == "half":
            rows = t.shape[0] // 2
            return t[block[1] * rows:(block[1] + 1) * rows]
        t = t[block[1]]
        return t if len(block) == 2 else _part(t, ("half", block[2]))
    rows = t.shape[0] // 3
    return t[block * rows:(block + 1) * rows]


def _copy_into(module: nn.Module, plan: list, state_dict: Mapping) -> None:
    """Copy ``state_dict`` into ``module``'s parameters by ``plan``: tuples
    (source name, port name, its part (:func:`_part`), transform of the
    source tensor or None).  Every source name and every shape is checked
    before anything is copied."""
    params = module.state_dict()
    missing = [src for src, *_ in plan if src not in state_dict]
    if missing:
        raise KeyError(f"missing {missing[0]} in state dict"
                       + (f" (and {len(missing) - 1} more)"
                          if len(missing) > 1 else ""))
    moves = []
    for src, dst, block, fn in plan:
        val = _f32(state_dict[src])
        if fn is not None:
            val = fn(val)
        target = _part(params[dst], block)
        if tuple(val.shape) != tuple(target.shape):
            raise ValueError(f"{src} {tuple(val.shape)} does not fit {dst} "
                             f"{tuple(target.shape)}")
        moves.append((target, val))
    with torch.no_grad():
        for target, val in moves:
            target.copy_(val)


# ------------------------------------------------------------ T5

def hf_encoder_mapping(num_layers: int, num_experts: int = 0,
                       sparse_step: int = 0) -> dict[str, tuple[str, object]]:
    """HF T5 name → (the port's parameter, its part (:func:`_part`)) for
    the encoder and shared embeddings.  With ``num_experts``, a Switch
    Transformer's names (``SwitchTransformersEncoderModel``): the FFN is
    ``mlp``, and at the sparse layers the router and each expert's ``wi`` /
    ``wo``, stacked into the port's ``[E, …]`` tensors."""
    m: dict[str, tuple[str, int | None]] = {
        "shared.weight": ("shared.weight", None),
        "encoder.final_layer_norm.weight": ("encoder.final_norm.scale", None),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
        "weight": ("encoder.rel_bias.rel_embedding", None),
    }
    for i in range(num_layers):
        hf, my = f"encoder.block.{i}.layer", f"encoder.blocks.{i}"
        for j, proj in enumerate("qkv"):
            m[f"{hf}.0.SelfAttention.{proj}.weight"] = (f"{my}.attn.qkv.weight",
                                                        j)
        m[f"{hf}.0.SelfAttention.o.weight"] = (f"{my}.attn.o.weight", None)
        m[f"{hf}.0.layer_norm.weight"] = (f"{my}.ln1.scale", None)
        if not num_experts:
            for w in ("wi", "wo"):
                m[f"{hf}.1.DenseReluDense.{w}.weight"] = (
                    f"{my}.ff.{w}.weight", None)
        elif is_sparse(i, sparse_step):
            m[f"{hf}.1.mlp.router.classifier.weight"] = (f"{my}.ff.router",
                                                         None)
            for j in range(num_experts):
                for w in ("wi", "wo"):
                    m[f"{hf}.1.mlp.experts.expert_{j}.{w}.weight"] = (
                        f"{my}.ff.{w}", ("expert", j))
        else:
            for w in ("wi", "wo"):
                m[f"{hf}.1.mlp.{w}.weight"] = (f"{my}.ff.{w}.weight", None)
        m[f"{hf}.1.layer_norm.weight"] = (f"{my}.ln2.scale", None)
    return m


def _experts(cfg) -> tuple[int, int]:
    """(experts, encoder sparse step) of a model config, (0, 0) for T5."""
    return (getattr(cfg, "num_experts", 0),
            getattr(cfg, "encoder_sparse_step", 0))


def load_t5_encoder(model: nn.Module, state_dict: Mapping,
                    num_layers: int) -> nn.Module:
    """Copy a HF T5 (or, for a model with experts, Switch Transformer)
    state dict's encoder and shared embeddings into a
    ``GenerativeRetriever`` (or ``Seq2SeqLM``); the decoder side, decoder.*
    and lm_head of the source are ignored.  Returns ``model``."""
    mapping = hf_encoder_mapping(num_layers,
                                 *_experts(getattr(model, "cfg", None)))
    _copy_into(model, [(src, dst, block, None) for src, (dst, block)
                       in mapping.items()], state_dict)
    return model


def export_t5_encoder(state_dict: Mapping[str, torch.Tensor],
                      num_layers: int, num_experts: int = 0,
                      sparse_step: int = 0) -> dict[str, np.ndarray]:
    """Inverse of :func:`load_t5_encoder`: the encoder and shared
    embeddings of a port state_dict under HF T5 (or Switch) names, as the
    ``.npz`` that ``train --t5-ckpt`` reads."""
    out = {}
    for src, (dst, block) in hf_encoder_mapping(num_layers, num_experts,
                                                sparse_step).items():
        val = _part(state_dict[dst].detach().cpu().float(), block)
        out[src] = val.numpy().copy()
    return out


def state_dict_from_pretrained(path: str) -> dict[str, torch.Tensor]:
    """A HF T5 checkpoint directory's tensors; a ``.npz`` path loads an
    :func:`export_t5_encoder` dump instead (either package's)."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: torch.from_numpy(z[k]).float() for k in z.files}
    return read_state_dict(path)


# ------------------------------------------------------------ BERT

_BERT_PREFIXES = ("ctx_encoder.bert_model.", "ctx_model.", "bert.",
                  "bert_model.", "")
_BERT_LAYER = (("attention.self.query", "attn.query"),
               ("attention.self.key", "attn.key"),
               ("attention.self.value", "attn.value"),
               ("attention.output.dense", "attn.out"),
               ("attention.output.LayerNorm", "ln1"),
               ("intermediate.dense", "ff1"),
               ("output.dense", "ff2"),
               ("output.LayerNorm", "ln2"))


def bert_state_dict_from_pretrained(path: str) -> dict[str, torch.Tensor]:
    """A HF BERT-family checkpoint directory's tensors (plain BERT,
    BertForPreTraining, DPR context encoders, AR2 exports) under the
    file's own names; :func:`load_bert_encoder` normalises the prefixes."""
    return read_state_dict(path)


def load_bert_encoder(model: nn.Module, state_dict: Mapping) -> nn.Module:
    """Copy a HF BERT state dict into the port's ``DocEncoder``.  Names may
    carry DPR's ``ctx_encoder.bert_model.``, AR2's ``ctx_model.`` or
    BertForPreTraining's ``bert.`` prefix; heads (``cls.*``), the pooler
    and ``position_ids`` buffers are ignored.  Returns ``model``."""
    sd = {}
    for k, v in state_dict.items():
        for pref in _BERT_PREFIXES:
            if k.startswith(pref):
                sd[k[len(pref):]] = v
                break
    plan = [(f"embeddings.{hf}", my, None, None) for hf, my in (
        ("word_embeddings.weight", "tok_embed.weight"),
        ("position_embeddings.weight", "pos_embed.weight"),
        ("token_type_embeddings.weight", "type_embed.weight"),
        ("LayerNorm.weight", "embed_ln.weight"),
        ("LayerNorm.bias", "embed_ln.bias"))]
    for i in range(model.cfg.num_layers):
        for hf, my in _BERT_LAYER:
            for leaf in ("weight", "bias"):
                plan.append((f"encoder.layer.{i}.{hf}.{leaf}",
                             f"blocks.{i}.{my}.{leaf}", None, None))
    _copy_into(model, plan, sd)
    return model


# ------------------------------------------------------------ the fork

def load_gdr_reference(model: nn.Module, state_dict: Mapping) -> nn.Module:
    """Copy the reference fork's full model (its ``T5ForConditionalGeneration``
    with a separate ``decode_embeddings`` table, an untied ``lm_head`` and
    the efficient PAWA adaptor built from ``nn.TransformerDecoderLayer``)
    into a ``GenerativeRetriever``.  Returns ``model``.

    - torch ``MultiheadAttention`` scales q by head_dim**-0.5 after the
      projection; the port's attention is unscaled, so the scale is folded
      into the q rows of ``qkv``.
    - The adaptor's projection biases have no counterpart (the adaptor is
      biasless, T5-style): they must be zero in the source.
    - ``adaptor_linear.weight`` [d·V, d] (out index o = i·V + v) becomes
      U [d_j, V, d_i]: ``W.reshape(d, V, d).permute(2, 1, 0)``.
    - ``lm_head.weight`` [V, d] becomes the port's ``lm_head`` [d, V].
    """
    cfg = model.cfg
    params = model.state_dict()
    plan = [(src, dst, block, None) for src, (dst, block)
            in hf_encoder_mapping(cfg.num_layers).items()]
    rel = "relative_attention_bias.weight"
    plan += [("decoder.final_layer_norm.weight", "decoder.final_norm.scale",
              None, None),
             (f"decoder.block.0.layer.0.SelfAttention.{rel}",
              "decoder.rel_bias.rel_embedding", None, None),
             (f"decoder.block.0.layer.1.EncDecAttention.{rel}",
              "decoder.cross_rel_bias.rel_embedding", None, None)]
    for i in range(cfg.num_decoder_layers):
        hf, my = f"decoder.block.{i}.layer", f"decoder.blocks.{i}"
        for sub, attn in (("0.SelfAttention", "self_attn"),
                          ("1.EncDecAttention", "cross_attn")):
            for j, proj in enumerate("qkv"):
                plan.append((f"{hf}.{sub}.{proj}.weight",
                             f"{my}.{attn}.qkv.weight", j, None))
            plan.append((f"{hf}.{sub}.o.weight", f"{my}.{attn}.o.weight",
                         None, None))
        for n in (0, 1, 2):
            plan.append((f"{hf}.{n}.layer_norm.weight", f"{my}.ln{n + 1}.scale",
                         None, None))
        for w in ("wi", "wo"):
            plan.append((f"{hf}.2.DenseReluDense.{w}.weight",
                         f"{my}.ff.{w}.weight", None, None))
    plan.append(("decode_embeddings.weight", "decode_embed.weight", None,
                 None))
    if "lm_head" in params:
        plan.append(("lm_head.weight", "lm_head", None, lambda w: w.t()))
    if "pawa.u" in params:
        d = cfg.d_model
        scale = (d // cfg.adaptor_num_heads) ** -0.5
        plan.append(("adaptor_embeddings", "pawa.memory", None, None))
        for i in range(cfg.adaptor_layer_num):
            hf, my = f"adaptor.layers.{i}", f"pawa.layers.{i}"
            for src, attn in (("self_attn", "self_attn"),
                              ("multihead_attn", "cross_attn")):
                w = f"{hf}.{src}.in_proj_weight"
                plan += [(w, f"{my}.{attn}.qkv.weight", 0,
                          lambda t, d=d: t[:d] * scale),
                         (w, f"{my}.{attn}.qkv.weight", 1,
                          lambda t, d=d: t[d:2 * d]),
                         (w, f"{my}.{attn}.qkv.weight", 2,
                          lambda t, d=d: t[2 * d:]),
                         (f"{hf}.{src}.out_proj.weight",
                          f"{my}.{attn}.o.weight", None, None)]
                _zero_bias(state_dict, f"{hf}.{src}.in_proj_bias")
                _zero_bias(state_dict, f"{hf}.{src}.out_proj.bias")
            for lin, ff in (("linear1", "ff1"), ("linear2", "ff2")):
                plan.append((f"{hf}.{lin}.weight", f"{my}.{ff}.weight", None,
                             None))
                _zero_bias(state_dict, f"{hf}.{lin}.bias")
            for n in (1, 2, 3):
                for leaf in ("weight", "bias"):
                    plan.append((f"{hf}.norm{n}.{leaf}",
                                 f"{my}.ln{n}.{leaf}", None, None))
        plan.append(("adaptor_linear.weight", "pawa.u", None,
                     lambda w, d=d: w.reshape(d, -1, d).permute(2, 1, 0)))
    _copy_into(model, plan, state_dict)
    return model


def _zero_bias(state_dict: Mapping, name: str) -> None:
    b = state_dict.get(name)
    if b is not None and bool(_f32(b).any()):
        raise ValueError(f"{name} must be zero: the port's PAWA adaptor is "
                         f"biasless (T5-style)")


# ------------------------------------------------------------ DeepSeek-V3

def deepseek_v3_model_overrides(path: str) -> dict:
    """``ModelConfig`` fields of a ``deepseek_v3`` checkpoint directory's
    ``config.json`` (Moonlight-16B-A3B's keys); the decoder-only stack
    serves one group (``n_group`` 1), no q LoRA and no RoPE scaling."""
    c = read_config(path)
    if c.get("model_type") != "deepseek_v3":
        raise ValueError(f"{path}: model_type {c.get('model_type')!r}, not "
                         f"deepseek_v3")
    if c.get("q_lora_rank") or c.get("rope_scaling") or \
            c.get("n_group", 1) != 1 or c.get("attention_bias"):
        raise ValueError(f"{path}: q LoRA, RoPE scaling, expert groups and "
                         f"attention biases are not ported")
    return dict(backbone="deepseek_v3", vocab_size=c["vocab_size"],
                d_model=c["hidden_size"], num_layers=c["num_hidden_layers"],
                num_heads=c["num_attention_heads"],
                d_ff=c["intermediate_size"], kv_lora_rank=c["kv_lora_rank"],
                qk_nope_head_dim=c["qk_nope_head_dim"],
                qk_rope_head_dim=c["qk_rope_head_dim"],
                v_head_dim=c["v_head_dim"], rope_theta=c["rope_theta"],
                layer_norm_epsilon=c["rms_norm_eps"],
                num_experts=c["n_routed_experts"],
                moe_d_ff=c["moe_intermediate_size"],
                num_experts_per_tok=c["num_experts_per_tok"],
                num_shared_experts=c["n_shared_experts"],
                first_k_dense=c["first_k_dense_replace"],
                routed_scaling_factor=c["routed_scaling_factor"])


def deepseek_v3_mapping(cfg) -> dict[str, tuple[str, object]]:
    """``transformers``' DeepseekV3 name (Moonlight's checkpoint, without
    the ``model.`` prefix) → (the port's parameter, its part): the token
    embedding, every layer and the final norm.  ``lm_head`` has none: GDR's
    CID head takes its place."""
    m = {"embed_tokens.weight": ("shared.weight", None),
         "norm.weight": ("stack.final_norm.scale", None)}
    for i in range(cfg.num_layers):
        hf, my = f"layers.{i}", f"stack.blocks.{i}"
        m.update({
            f"{hf}.input_layernorm.weight": (f"{my}.ln1.scale", None),
            f"{hf}.post_attention_layernorm.weight": (f"{my}.ln2.scale", None),
            f"{hf}.self_attn.q_proj.weight": (f"{my}.attn.q_proj.weight",
                                              None),
            f"{hf}.self_attn.kv_a_proj_with_mqa.weight":
                (f"{my}.attn.kv_a.weight", None),
            f"{hf}.self_attn.kv_a_layernorm.weight":
                (f"{my}.attn.kv_norm.scale", None),
            f"{hf}.self_attn.kv_b_proj.weight": (f"{my}.attn.kv_b.weight",
                                                 None),
            f"{hf}.self_attn.o_proj.weight": (f"{my}.attn.o.weight", None)})
        if i < cfg.first_k_dense:
            m.update({f"{hf}.mlp.gate_proj.weight": (f"{my}.ff.wi.weight",
                                                     ("half", 0)),
                      f"{hf}.mlp.up_proj.weight": (f"{my}.ff.wi.weight",
                                                   ("half", 1)),
                      f"{hf}.mlp.down_proj.weight": (f"{my}.ff.wo.weight",
                                                     None)})
            continue
        m.update({
            f"{hf}.mlp.gate.weight": (f"{my}.ff.router", None),
            f"{hf}.mlp.gate.e_score_correction_bias": (f"{my}.ff.score_bias",
                                                       None),
            f"{hf}.mlp.shared_experts.gate_proj.weight":
                (f"{my}.ff.shared_wi", ("half", 0)),
            f"{hf}.mlp.shared_experts.up_proj.weight":
                (f"{my}.ff.shared_wi", ("half", 1)),
            f"{hf}.mlp.shared_experts.down_proj.weight":
                (f"{my}.ff.shared_wo", None)})
        for j in range(cfg.num_experts):
            e = f"{hf}.mlp.experts.{j}"
            m.update({
                f"{e}.gate_proj.weight": (f"{my}.ff.wi", ("expert", j, 0)),
                f"{e}.up_proj.weight": (f"{my}.ff.wi", ("expert", j, 1)),
                f"{e}.down_proj.weight": (f"{my}.ff.wo", ("expert", j))})
    return m


def load_deepseek_v3(model: nn.Module, state_dict: Mapping) -> nn.Module:
    """Copy a ``transformers`` DeepseekV3 state dict (a
    ``DeepseekV3ForCausalLM`` checkpoint's ``model.*`` names, or a
    ``DeepseekV3Model``'s bare ones) into a decoder-only
    ``GenerativeRetriever``; GDR's own heads are left as they are.
    Returns ``model``."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in state_dict.items()}
    _copy_into(model, [(src, dst, block, None) for src, (dst, block)
                       in deepseek_v3_mapping(model.cfg).items()], sd)
    return model
