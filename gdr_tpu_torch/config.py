"""Configuration dataclasses for the PyTorch port.

A copy of ``gdr_tpu/config.py`` (the port imports nothing of ``gdr_tpu``).
Three differences, because the device of the tensors decides which code
runs:

- ``EvalConfig`` has no ``fused_decode``: on a CUDA device the decoder
  sublayers always run as the hand-written kernels, on the CPU always as
  their plain PyTorch versions;
- ``TrainConfig`` has no ``async_checkpointing``: a checkpoint is written
  synchronously, to a temporary file renamed into place;
- ``MeshConfig`` lays its dp × mp mesh over processes, one per GPU
  (``parallel/mesh.py``), where the reference lays it over devices.

Derived quantities (``decode_vocab_size = kary * max_output_length + 2``)
are computed properties, as in the reference package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the generative retriever (T5 encoder-decoder + PAWA)."""

    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12             # encoder depth
    num_decoder_layers: int = 6
    num_heads: int = 12
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128

    # --- docid decoding head
    kary: int = 30
    max_output_length: int = 10
    position: bool = True
    tie_decode_embedding: bool = True

    # --- PAWA adaptor
    adaptor_decode: bool = True
    adaptor_efficient: bool = True
    adaptor_layer_num: int = 4
    adaptor_num_heads: int = 8
    adaptor_d_ff: int = 0            # 0 → min(4·d_model, 2048)

    # --- regularisation (training only)
    rdrop: float = 0.1
    rdrop_loss: str = "Contrast"
    input_dropout: float = 0.5
    denoising: bool = False
    embedding_distillation: float = 0.0
    weight_distillation: float = 0.0

    # --- dense stage
    encoder_d_model: int = 768
    query_source: str = "encoder"
    concate_fusion: bool = False

    remat: bool = False

    # --- sparse experts (Switch Transformer): at the layers ``i`` of a stack
    # with ``i % step == 1`` (every layer at step 1, none at step 0) the FFN
    # is a top-1 routed mixture of ``num_experts`` ReLU experts, each taking
    # at most ``expert_capacity`` tokens of a sequence; 0 experts is dense
    num_experts: int = 0
    expert_capacity: int = 64
    encoder_sparse_step: int = 2
    decoder_sparse_step: int = 2

    # --- decoder-only backbone ("deepseek_v3": DeepSeek-V3's block, as
    # Moonlight publishes it): ``num_layers`` causal layers of latent
    # attention (MLA) over the query, then GDR's CID steps
    # (``models/deepseek.py``); the first ``first_k_dense`` FFNs are dense
    # SwiGLU of width ``d_ff``, the rest mixtures of ``num_experts`` SwiGLU
    # experts of width ``moe_d_ff``, ``num_experts_per_tok`` a token by
    # sigmoid scores plus a selection-only bias, and ``num_shared_experts``
    # always taken; ``num_decoder_layers`` and ``d_kv`` are T5's only
    backbone: str = "t5"             # "t5" | "deepseek_v3" | "kimi_linear"
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    moe_d_ff: int = 1408
    num_experts_per_tok: int = 1
    num_shared_experts: int = 0
    first_k_dense: int = 1
    routed_scaling_factor: float = 1.0
    # --- the chip's share of an expert-parallel deployment: the router
    # scores all ``num_experts`` experts and picks the top k over them, and
    # this chip holds and computes experts ``expert_offset`` …
    # ``expert_offset + experts_held − 1`` (0 held: all of them)
    experts_held: int = 0
    expert_offset: int = 0

    # --- "kimi_linear" (Kimi Linear's hybrid stack, ``models/
    # kimi_linear.py``): the 1-based layers of ``kda_layers`` are gated
    # delta-rule (KDA) layers of ``kda_num_heads`` heads of ``kda_head_dim``
    # with a causal depthwise convolution of ``kda_conv_size`` taps, those
    # of ``full_attn_layers`` MLA layers; ``mla_use_nope``: MLA without
    # rotary embeddings (its rope columns unrotated)
    kda_layers: tuple = ()
    full_attn_layers: tuple = ()
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    kda_conv_size: int = 4
    mla_use_nope: bool = False

    def __post_init__(self):
        for name in ("kda_layers", "full_attn_layers"):  # JSON gives lists
            object.__setattr__(self, name, tuple(getattr(self, name)))

    @property
    def decoder_only(self) -> bool:
        return self.backbone in ("deepseek_v3", "kimi_linear")

    @property
    def n_held(self) -> int:
        """The routed experts this chip holds."""
        return self.experts_held or self.num_experts

    def is_kda(self, i: int) -> bool:
        """Whether the 0-based layer ``i`` is a KDA layer."""
        return self.backbone == "kimi_linear" and i + 1 in self.kda_layers

    def refuse_experts(self, what: str) -> None:
        """Raise where ``what`` is asked of a model with experts, which the
        port serves but does not train."""
        if self.num_experts:
            raise NotImplementedError(
                f"{what} is not ported for sparse experts (num_experts "
                f"{self.num_experts}): the router's z-loss and load-balancing"
                f" loss and the experts' column-parallel placement are "
                f"missing")

    @property
    def output_vocab_size(self) -> int:
        return self.kary

    @property
    def decode_vocab_size(self) -> int:
        """pad(0) + eos(1) + kary tokens per position."""
        if self.position:
            return self.output_vocab_size * self.max_output_length + 2
        return self.output_vocab_size + 2

    def scaled(self, preset: str) -> "ModelConfig":
        presets = {
            "base": dict(num_layers=12, num_decoder_layers=6, d_model=768,
                         num_heads=12, d_ff=3072, d_kv=64),
            "large": dict(num_layers=24, num_decoder_layers=12, d_model=1024,
                          num_heads=16, d_ff=4096, d_kv=64),
            "small": dict(num_layers=6, num_decoder_layers=3, d_model=512,
                          num_heads=8, d_ff=2048, d_kv=64),
            "tiny": dict(num_layers=2, num_decoder_layers=2, d_model=64,
                         num_heads=4, d_ff=128, d_kv=16),
            # google/switch-base-128 (Fedus et al. 2021): t5-base widths,
            # every other FFN a top-1 mixture of 128 experts
            "switch-base": dict(num_layers=12, num_decoder_layers=6,
                                d_model=768, num_heads=12, d_ff=3072, d_kv=64,
                                num_experts=128, expert_capacity=64,
                                encoder_sparse_step=2, decoder_sparse_step=2),
            # moonshotai/Moonlight-16B-A3B (DeepSeek-V3's block): 27 MLA
            # layers, the first a dense SwiGLU, then 64 routed experts
            # top-6 and 2 shared
            "moonlight-16b-a3b": dict(
                backbone="deepseek_v3", vocab_size=163840, d_model=2048,
                num_layers=27, num_heads=16, d_ff=11264, kv_lora_rank=512,
                qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                rope_theta=50000.0, layer_norm_epsilon=1e-5,
                num_experts=64, moe_d_ff=1408, num_experts_per_tok=6,
                num_shared_experts=2, first_k_dense=1,
                routed_scaling_factor=2.446),
            # moonshotai/Kimi-Linear-48B-A3B-Instruct: 27 layers at 3 KDA :
            # 1 NoPE MLA, the first FFN a dense SwiGLU, then 256 routed
            # experts top-8 and 1 shared; held here: card 0's 32 of 8
            "kimi-linear-48b-a3b": dict(
                backbone="kimi_linear", vocab_size=163840, d_model=2304,
                num_layers=27, num_heads=32, d_ff=9216, kv_lora_rank=512,
                qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                rope_theta=10000.0, layer_norm_epsilon=1e-5,
                mla_use_nope=True, num_experts=256, experts_held=32,
                expert_offset=0, moe_d_ff=1024, num_experts_per_tok=8,
                num_shared_experts=1, first_k_dense=1,
                routed_scaling_factor=2.446,
                kda_layers=tuple(i for i in range(1, 27) if i % 4),
                full_attn_layers=(4, 8, 12, 16, 20, 24, 27),
                kda_num_heads=32, kda_head_dim=128, kda_conv_size=4),
            # one period of it for the CPU tests: a KDA layer with the dense
            # FFN, two KDA and one MLA layer with 16 experts top-4, 8 held
            "kimi-linear-tiny": dict(
                backbone="kimi_linear", vocab_size=128, d_model=64,
                num_layers=4, num_heads=2, d_ff=96, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                rope_theta=10000.0, layer_norm_epsilon=1e-5,
                mla_use_nope=True, num_experts=16, experts_held=8,
                expert_offset=0, moe_d_ff=32, num_experts_per_tok=4,
                num_shared_experts=1, first_k_dense=1,
                routed_scaling_factor=2.446, kda_layers=(1, 2, 3),
                full_attn_layers=(4,), kda_num_heads=2, kda_head_dim=16,
                kda_conv_size=4),
        }
        return dataclasses.replace(self, **presets[preset])


@dataclass(frozen=True)
class IndexConfig:
    kary: int = 30
    leaf_cap: int = 30
    max_iters: int = 25
    seed: int = 7
    embedding_dim: int = 768
    minibatch_threshold: int = 1000
    minibatch_size: int = 1024
    max_docs_per_cluster: int = 64


@dataclass(frozen=True)
class DataConfig:
    max_input_length: int = 40
    doc_length: int = 64
    encoder_max_len: int = 128
    max_intraclass_num: int = 10
    query_type: str = "gtq_qg"
    aug_query: bool = False
    hard_negative: bool = False
    sample_neg_num: int = 0
    label_length_cutoff: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Training loop configuration (six AdamW groups, two stages)."""

    train_batch_size: int = 64
    eval_batch_size: int = 1
    stage2_train_batch_size: int = 32
    stage2_eval_batch_size: int = 1
    num_train_epochs: int = 500
    train_encoder_epoch: int = 51    # stage-1 → stage-2 switch
    learning_rate: float = 2e-4      # T5 encoder + shared embeddings
    decoder_learning_rate: float = 1e-4
    doc_encoder_learning_rate: float = 2e-4
    weight_decay: float = 1e-4
    adam_epsilon: float = 1e-8
    warmup_steps: int = 0
    scheduler: str = "linear"        # "linear" | "exp"
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    seed: int = 42
    tau: float = 0.05                # contrastive temperature
    intra_rate: float = 1.0          # intra-cluster denominator weight
    loss_func: str = "tanh"          # similarity squashing: "tanh" | "sigmoid"
    bf16: bool = True                # bf16 compute over f32 master weights
    checkpoint_dir: str = "checkpoints"
    save_top_k: int = 1
    monitor: str = "recall1"
    log_every_steps: int = 50
    # stage-2 store refresh: fraction of the corpus re-embedded per eval
    # epoch (a rotating slice); 1.0 re-embeds it all
    stage2_refresh_fraction: float = 1.0


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation / retrieval operating point."""

    num_beams: int = 100
    num_return_sequences: int = 100
    max_output_length: int = 10
    length_penalty: float = 0.8
    score_rates: Sequence[float] = (0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
    recall_ks: Sequence[int] = (1, 5, 10, 20, 50, 100)
    accuracy_ks: Sequence[int] = (1, 20, 100)
    mrr_ks: Sequence[int] = (10, 100)
    map_k: int = 100
    use_query_embed_encoder: bool = True
    use_query_embed_decoder_avg: bool = False
    use_query_embed_decoder_special: bool = False
    fusion_strategy: str = "average"
    gen_method: str = "beam"
    temperature: float = 1.0
    sample_top_k: int = 0
    sample_seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Process mesh: dp (batch) × mp (parameter) ranks, one per GPU; the
    doc-embedding store is row-sharded over the flattened mesh."""

    dp: int = -1                     # -1 → every rank of the world
    mp: int = 1
    axis_names: Sequence[str] = ("dp", "mp")
    tp_min_size: int = 1 << 14       # smallest parameter (elements) whose
                                     # masters and moments shard over mp


@dataclass(frozen=True)
class GDRConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw: Any) -> "GDRConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(kary: int = 4, max_output_length: int = 5, d_model: int = 32,
                embedding_dim: int = 16) -> GDRConfig:
    """The CPU-testable configuration of the reference package's tests."""
    model = ModelConfig(
        kary=kary, max_output_length=max_output_length,
        d_model=d_model, d_kv=16, d_ff=64, num_layers=2, num_decoder_layers=1,
        num_heads=2, vocab_size=128, encoder_d_model=embedding_dim,
        adaptor_layer_num=1, adaptor_num_heads=2, dropout_rate=0.1)
    index = IndexConfig(kary=kary, leaf_cap=8, embedding_dim=embedding_dim,
                        max_docs_per_cluster=16)
    data = DataConfig(max_input_length=16, doc_length=16, encoder_max_len=32,
                      max_intraclass_num=4)
    train = TrainConfig(train_batch_size=4, eval_batch_size=2,
                        num_train_epochs=2, train_encoder_epoch=1)
    ev = EvalConfig(num_beams=8, num_return_sequences=8,
                    max_output_length=max_output_length)
    return GDRConfig(model=model, index=index, data=data, train=train,
                     eval=ev)
