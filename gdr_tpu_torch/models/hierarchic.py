"""Hierarchic decoding — one decoder stack per CID depth, mirroring
``gdr_tpu/models/hierarchic.py``.

Depth ``p`` of the docid is decoded by its own T5 stack: in training every
stack runs the full sequence and position ``p``'s logits come from stack
``min(p, D-1)``; at decode step ``p`` that stack re-runs teacher-forced over
the emitted prefix (positions 0..p) and its position-``p`` row is the
step's logits (the
reference package's module note: this matches the training distribution,
which the original repository's cache-sharing decode does not).

:class:`Hierarchic` holds ``base`` (a :class:`GenerativeRetriever` without
its decoder: shared, encoder, decode embeddings, head, PAWA) and
``decoders``, one ``models/t5.py::Decoder`` per depth.  The path is plain
PyTorch, as the reference's is plain XLA; its dense re-rank runs the
``rerank_scores`` kernel on a CUDA store (``ops/rerank.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights, \
    shift_right
from gdr_tpu_torch.models.t5 import Decoder
from gdr_tpu_torch.ops.beam import beam_search


class Hierarchic(nn.Module):
    def __init__(self, cfg: ModelConfig, depth: int):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.base = GenerativeRetriever(cfg)
        del self.base.decoder
        self.decoders = nn.ModuleList([Decoder(
            c.num_decoder_layers, c.d_model, c.num_heads, c.d_kv, c.d_ff,
            c.layer_norm_epsilon, c.relative_attention_num_buckets,
            c.relative_attention_max_distance, c.dropout_rate, c.remat)
            for _ in range(depth)])
        self.eval()

    @property
    def depth(self) -> int:
        return len(self.decoders)

    @property
    def device(self) -> torch.device:
        return self.base.device

    def stack_logits(self, i: int, enc, enc_mask, decoder_input_ids,
                     decoder_attn_mask) -> torch.Tensor:
        """Teacher-forced full-vocab logits [B, L, V] through stack ``i``."""
        return self.base.decode_logits(enc, enc_mask, decoder_input_ids,
                                       decoder_attn_mask,
                                       decoder=self.decoders[i])[0]


@torch.no_grad()
def init_hierarchic(cfg: ModelConfig, depth: int,
                    generator: torch.Generator) -> Hierarchic:
    """Seeded weights at ``models/gdr.py::init_weights``' scales: the base,
    then each depth's stack (norm scales 1, every other weight N(0, 0.02),
    as init_weights gives a retriever's decoder)."""
    with torch.device(generator.device):
        h = Hierarchic(cfg, depth)
    init_weights(h.base, generator)
    for dec in h.decoders:
        for name, p in dec.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * 0.02)
    return h


def hierarchic_logits(h: Hierarchic, input_ids, attn_mask, labels,
                      label_mask) -> torch.Tensor:
    """Teacher-forced logits [B, L, V]: position ``p`` from stack
    ``min(p, D-1)``, every stack running the full sequence."""
    enc = h.base.encode(input_ids, attn_mask)
    dec_in = shift_right(labels)
    per_stack = [h.stack_logits(i, enc, attn_mask, dec_in, label_mask)
                 for i in range(h.depth)]
    return torch.stack([per_stack[min(p, h.depth - 1)][:, p]
                        for p in range(labels.shape[1])], dim=1)


def hierarchic_decode_step(h: Hierarchic, prefix_tokens, enc, attn_mask,
                           pos: int) -> torch.Tensor:
    """Logits [B, V] of position ``pos`` from stack ``min(pos, D-1)``,
    re-run over the prefix [B, L] (start token + emitted tokens, padded).
    ``gdr_tpu`` runs all L positions with those after ``pos`` masked; the
    decoder and PAWA are causal, so positions 0..pos alone give the same
    row, and only they run here."""
    prefix = prefix_tokens[:, :pos + 1]
    return h.stack_logits(min(pos, h.depth - 1), enc, attn_mask, prefix,
                          torch.ones_like(prefix, dtype=torch.int32))[:, pos]


@torch.no_grad()
def hierarchic_generate_cids(h: Hierarchic, input_ids, attn_mask, children,
                             eos_allowed, num_beams: int, max_len: int,
                             length_penalty: float = 1.0):
    """Trie-constrained beam search with the per-depth stacks: step ``p``
    re-runs stack ``min(p, D-1)`` over the emitted prefix (the cache's
    batch-major ``prefix``, reordered with its beams) against the per-beam
    encoder rows (``cross_``-prefixed, never reordered); the full-vocab
    logits feed ``ops/beam.py::beam_search(candidates_mode=False)``.
    ``num_beams=1`` is the reference's greedy decode.  Returns
    (BeamResult, query embedding [B, d'])."""
    batch = input_ids.shape[0]
    enc = h.base.encode(input_ids, attn_mask)
    query_emb = h.base.query_embedding(enc)
    bk = batch * num_beams
    cache = {
        "cross_enc": torch.repeat_interleave(enc, num_beams, dim=0),
        "cross_msk": torch.repeat_interleave(attn_mask, num_beams, dim=0),
        "prefix": torch.zeros((bk, max_len), dtype=torch.long,
                              device=enc.device),
    }

    def step_fn(cur_tok, cache, pos, width):
        prefix = cache["prefix"].clone()
        prefix[:, pos] = cur_tok
        logits = hierarchic_decode_step(h, prefix, cache["cross_enc"],
                                        cache["cross_msk"], pos)
        return logits, {**cache, "prefix": prefix}

    result = beam_search(step_fn, cache, batch, num_beams, h.cfg.kary,
                         max_len, children, eos_allowed, length_penalty,
                         progressive=False, candidates_mode=False)
    return result, query_emb
