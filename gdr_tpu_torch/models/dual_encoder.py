"""The document tower of the dense stage, mirroring
``gdr_tpu/models/dual_encoder.py``: a BERT-style encoder (learned token,
position and type-0 embeddings, post-LN blocks, exact erf GELU, LayerNorm
eps 1e-12) pooled at the CLS position.  It embeds the corpus for the index
and the documents that corpus expansion adds.

Plain PyTorch, no dropout.  It embeds with whole weights; in the stage-2
train step over a mesh that cuts its leaves (``parallel/mesh.py``;
``mp_mesh`` set) each Dense is column-parallel (query / key / value cut
inside each head, as ``gdr_tpu`` cuts their ``[d, H, dh]`` kernels on
``dh``, and gathered before the core) and each embedding is looked up in
this rank's columns and gathered.  The model dtype is the
parameters' dtype (f32 by default; the bench embeds in bf16).  Rounding
points follow flax's ``MultiHeadDotProductAttention``, ``Dense`` and
``LayerNorm`` at that dtype:

- Dense layers compute ``x·W`` in the model dtype, then add the bias;
- the query is divided by √head_dim (in the model dtype) before the
  product with the keys; masked scores are ``finfo(dtype).min``; the
  softmax takes ``jax.nn.softmax``'s steps in the model dtype (the
  exponentials and their sum each rounded to it before the division);
- the exact GELU is ``jax.nn.gelu``'s ``0.5·x · erfc(−x·√½)``, each
  product rounded to the model dtype;
- LayerNorm statistics (mean and E[x²] − mean²) and the scale and bias are
  taken in f32, and the result is rounded to the model dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from gdr_tpu_torch.parallel.autograd import (column_linear, embedding,
                                             gather_from_mp, mp_mesh)


@dataclass(frozen=True)
class DocEncoderConfig:
    """BERT-base by default (the reference's DPR context encoder)."""

    vocab_size: int = 30522
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 3072
    max_position: int = 512


def tiny_doc_encoder_config(d_model: int = 32) -> DocEncoderConfig:
    return DocEncoderConfig(vocab_size=512, d_model=d_model, num_layers=2,
                            num_heads=2, d_ff=64, max_position=64)


def _dense(x: torch.Tensor, lin: nn.Linear, module: nn.Module = None,
           blocks: int = 1) -> torch.Tensor:
    """``x·Wᵀ + b``; column-parallel over ``module``'s mesh where ``lin``
    holds this rank's rows (in ``blocks``), its bias added to this rank's
    columns when cut alike, else to the gathered output."""
    w = lin.weight
    if w.shape[0] == lin.out_features:
        return F.linear(x, w) + lin.bias
    mesh = mp_mesh(module)
    y = column_linear(x, w, mesh, blocks, gather=False)
    if lin.bias.shape[0] != lin.out_features:
        return gather_from_mp(y + lin.bias, mesh, -1, blocks)
    return gather_from_mp(y, mesh, -1, blocks) + lin.bias


def _whole(w: torch.Tensor, d: int, module: nn.Module) -> torch.Tensor:
    """An embedding table's rows ``w`` [..., d], gathered where its columns
    are cut over mp."""
    return w if w.shape[-1] == d else gather_from_mp(w, mp_mesh(module))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as BERT uses it, in x's dtype."""
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=torch.float32).to(x.dtype)
    return (0.5 * x) * torch.special.erfc(-x * sqrt_half)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with each step rounded to x's dtype."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True, dtype=torch.float32).to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: f32 statistics, scale and bias."""

    def __init__(self, d: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.weight.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with biased projections."""

    mp_mesh = None

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, L, d]; mask [B, 1, 1, L], True = attend."""
        b, l, d = x.shape
        h = self.num_heads
        dh = d // h
        q, k, v = (_dense(x, lin, self, h).view(b, l, h, dh)
                   for lin in (self.query, self.key, self.value))
        q = q / torch.tensor(dh, dtype=torch.float32).sqrt().to(q.dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        probs = _softmax(scores)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, d)
        return _dense(ctx, self.out, self)


class BertBlock(nn.Module):
    mp_mesh = None

    def __init__(self, d_model: int, num_heads: int, d_ff: int):
        super().__init__()
        self.attn = SelfAttention(d_model, num_heads)
        self.ln1 = LayerNorm(d_model)
        self.ff1 = nn.Linear(d_model, d_ff)
        self.ff2 = nn.Linear(d_ff, d_model)
        self.ln2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.attn(x, mask))
        return self.ln2(x + _dense(_gelu(_dense(x, self.ff1, self)),
                                   self.ff2, self))


class DocEncoder(nn.Module):
    """BERT-style document tower → CLS embedding."""

    mp_mesh = None

    def __init__(self, cfg: DocEncoderConfig = DocEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.tok_embed = nn.Embedding(cfg.vocab_size, d)
        self.pos_embed = nn.Embedding(cfg.max_position, d)
        # single-segment inputs: segment 0's type embedding (kept so that
        # pretrained BERT checkpoints map leaf for leaf)
        self.type_embed = nn.Embedding(2, d)
        self.embed_ln = LayerNorm(d)
        self.blocks = nn.ModuleList(
            BertBlock(d, cfg.num_heads, cfg.d_ff)
            for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_embed.weight.dtype

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor
                ) -> torch.Tensor:
        """input_ids / attn_mask [B, L] → doc embedding [B, d_model] in the
        model dtype."""
        l = input_ids.shape[1]
        if l > self.cfg.max_position:
            raise ValueError(f"{l} tokens exceed the tower's "
                             f"{self.cfg.max_position} positions")
        d = self.cfg.d_model
        x = (embedding(self, self.tok_embed, input_ids)
             + _whole(self.pos_embed.weight[:l], d, self)
             + _whole(self.type_embed.weight[0], d, self))
        x = self.embed_ln(x)
        mask = attn_mask[:, None, None, :].bool()
        for block in self.blocks:
            x = block(x, mask)
        return x[:, 0]


def tiny_doc_encoder(d_model: int = 32) -> DocEncoder:
    return DocEncoder(tiny_doc_encoder_config(d_model))


@torch.no_grad()
def init_doc_encoder(model: DocEncoder, generator: torch.Generator
                     ) -> DocEncoder:
    """Seeded random weights at flax's initialiser scales: embeddings
    N(0, 1/d), Dense weights N(0, 1/fan_in), biases 0, LayerNorm scales 1.
    The draws come from ``generator`` on its own device; they are not the
    reference package's draws (``convert.py`` bridges those)."""
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        if isinstance(modules[name.rsplit(".", 1)[0]], LayerNorm) \
                or name.endswith(".bias"):
            p.fill_(1.0 if name.endswith(".weight") else 0.0)
            continue
        fan_in = p.shape[1]
        r = torch.randn(p.shape, generator=generator, device=generator.device)
        p.copy_(r * fan_in ** -0.5)
    return model
