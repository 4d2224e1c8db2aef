"""Text-to-text T5 for query generation (docTTTTTquery), mirroring
``gdr_tpu/models/seq2seq.py``.

:class:`Seq2SeqLM` holds ``shared``, ``encoder`` and ``decoder``, the port's
own T5 stacks of ``models/t5.py``; its head is tied to the shared table
(``hidden · d^-0.5`` times ``shared.weightᵀ``, f32 logits).  Sampling
(:func:`sample`, :func:`generate_queries`) runs the KV-cached
``Decoder.decode_step``: on a CUDA tensor the three decoder-sublayer kernels
of ``kernels/decode.py`` at ``rows = docs × n_per_doc`` and one beam per
row, whose self-attention cache holds ``max_len`` positions (40 by the
CLI's default).  Each step draws ``argmax(logits / T + g)`` with Gumbel
noise ``g`` (the form of ``jax.random.categorical``) from a
``torch.Generator``, or noise the caller hands in.  Generated queries stay
token arrays and feed ``data/dataset.py::build_train_set_from_tokens``.

:func:`make_qg_train_step` is the teacher-forced doc→query fine-tuning
step: masked CE with dropout, then AdamW at optax's defaults (weight decay
1e-4 included, as ``optax.adamw(lr)`` gives the reference).
"""

from __future__ import annotations

import torch
from torch import nn

from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.models.t5 import Decoder, Encoder, set_dropout_generator
from gdr_tpu_torch.ops.beam import gumbel_noise
from gdr_tpu_torch.ops.losses import masked_cross_entropy
from gdr_tpu_torch.train.optimizer import OPTAX_ADAMW_WD, AdamW

EOS = 1
PAD = 0


class Seq2SeqLM(nn.Module):
    """T5 with a text lm-head tied to the shared embedding table.  Built in
    eval mode; its dtype is its parameters'."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        kw = (c.d_model, c.num_heads, c.d_kv, c.d_ff, c.layer_norm_epsilon,
              c.relative_attention_num_buckets,
              c.relative_attention_max_distance, c.dropout_rate)
        self.encoder = Encoder(c.num_layers, *kw)
        self.decoder = Decoder(c.num_decoder_layers, *kw)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        s = hidden * hidden.new_full((), self.cfg.d_model ** -0.5)
        return s.float() @ self.shared.weight.float().t()

    def encode(self, input_ids, attn_mask) -> torch.Tensor:
        return self.encoder(self.shared(input_ids), attn_mask)

    def forward(self, input_ids, attn_mask, decoder_input_ids,
                decoder_attn_mask) -> torch.Tensor:
        """Teacher-forced logits [B, L, vocab] f32."""
        enc = self.encode(input_ids, attn_mask)
        hidden = self.decoder(self.shared(decoder_input_ids), enc,
                              decoder_attn_mask, attn_mask)
        return self._logits(hidden)

    def init_cache(self, enc: torch.Tensor, max_len: int) -> dict:
        return self.decoder.init_cache(enc.shape[0], max_len, enc)

    def decode_step(self, token: torch.Tensor, cache: dict,
                    enc_mask: torch.Tensor, pos: int):
        """token [B] at ``pos`` → (logits [B, vocab] f32, cache)."""
        x = self.shared(token)[:, None]
        hidden, cache = self.decoder.decode_step(x, cache, enc_mask, pos)
        return self._logits(hidden[:, 0]), cache


@torch.no_grad()
def sample(model: Seq2SeqLM, input_ids, attn_mask, max_len: int,
           generator: torch.Generator | None = None,
           temperature: float = 1.0, top_k: int = 0,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """Ancestral sampling with optional top-k truncation: tokens
    [B, max_len] int32, PAD after EOS.  ``noise``: Gumbel noise
    [max_len, B, vocab] in place of the draws from ``generator``."""
    b = input_ids.shape[0]
    v = model.cfg.vocab_size
    if noise is None and generator is None:
        raise ValueError("sample: needs a generator or noise")
    if noise is not None and tuple(noise.shape) != (max_len, b, v):
        raise ValueError(f"sample: noise {tuple(noise.shape)}, need "
                         f"{(max_len, b, v)}")
    dev = model.device
    enc = model.encode(input_ids, attn_mask)
    cache = model.init_cache(enc, max_len)
    tok = torch.full((b,), PAD, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = []
    for pos in range(max_len):
        logits, cache = model.decode_step(tok, cache, attn_mask, pos)
        logits = logits / max(temperature, 1e-6)
        if top_k > 0:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, -1e9, logits)
        g = (noise[pos].to(dev, torch.float32) if noise is not None
             else gumbel_noise((b, v), generator))
        nxt = torch.argmax(logits + g, dim=-1)
        nxt = torch.where(done, PAD, nxt)
        done = done | (nxt == EOS)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1).to(torch.int32)


def generate_queries(model: Seq2SeqLM, doc_tokens, doc_mask, n_per_doc: int,
                     max_len: int, generator: torch.Generator | None = None,
                     temperature: float = 1.0, top_k: int = 10,
                     noise: torch.Tensor | None = None):
    """``n_per_doc`` sampled queries per document: (query tokens
    [B·n, max_len] int32, source doc row [B·n] int32)."""
    b = doc_tokens.shape[0]
    docs = torch.repeat_interleave(doc_tokens, n_per_doc, dim=0)
    mask = torch.repeat_interleave(doc_mask, n_per_doc, dim=0)
    out = sample(model, docs, mask, max_len, generator, temperature, top_k,
                 noise)
    src = torch.repeat_interleave(
        torch.arange(b, dtype=torch.int32, device=out.device), n_per_doc)
    return out, src


def qg_optimizer(model: nn.Module, lr: float) -> AdamW:
    """``optax.adamw(lr)``: one group, weight decay 1e-4 on every
    parameter."""
    return AdamW(model, {"all": (lr, OPTAX_ADAMW_WD)})


def make_qg_train_step(model: Seq2SeqLM, opt: AdamW):
    """``step(batch, generator) -> loss``: teacher-forced doc→query CE with
    dropout drawn from ``generator``, then one AdamW update.  Batch:
    ``doc_tokens`` / ``doc_mask`` [B, S], ``query_tokens`` [B, L]
    (0-padded, EOS-terminated), tensors on the model's device."""

    def step(batch: dict, generator: torch.Generator) -> torch.Tensor:
        q = batch["query_tokens"].long()
        dec_in = torch.cat([torch.zeros_like(q[:, :1]), q[:, :-1]], dim=1)
        mask = (q != PAD).to(torch.int32)
        model.train()
        set_dropout_generator(model, generator)
        try:
            logits = model(batch["doc_tokens"].long(), batch["doc_mask"],
                           dec_in, mask)
            loss = masked_cross_entropy(logits, q, mask)
            loss.backward()
        finally:
            model.eval()
            set_dropout_generator(model, None)
        opt.step()
        return loss.detach()

    return step
