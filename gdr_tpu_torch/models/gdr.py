"""The GDR generative retriever in PyTorch: T5 + positional decode head +
PAWA, mirroring the serving parts of ``gdr_tpu/models/gdr.py``.  With
``ModelConfig.backbone`` "deepseek_v3" or "kimi_linear" the T5
encoder-decoder is replaced by a decoder-only stack (``models/deepseek.py``,
``models/kimi_linear.py``): ``prefill`` runs the
query through it, the CID steps continue the same sequence, and the heads
and the search are the same; it serves only (the teacher-forced paths and
training are T5's).

- ``encode`` / ``query_embedding`` / ``project_query``: the T5 encoder and
  the dense-stage query rep (first-position encoder state, projected into
  the doc-embedding space when the widths differ);
- ``pool_query`` / ``fuse_queries``: the decoder-side query reps (masked
  mean or EOS-position decoder state) and their learned ``concate`` fusion
  with the encoder rep (the ``fusion`` layer, when
  ``ModelConfig.concate_fusion``);
- ``init_cache`` / ``decode_tables`` / ``decode_step_candidates``: the
  incremental decode of the constrained beam search.  Position ``pos`` can
  only emit its ``kary`` digit tokens or EOS, so the lm-head and the PAWA
  delta are computed for those ``kary+1`` columns only.  The slow PAWA head
  (``adaptor_efficient=False``) instead transforms the head input by its
  per-prefix [d, d] matrix;
- ``forward`` / ``decode_logits`` / ``decode_candidate_logits`` /
  ``decode_hidden``: the teacher-forced paths of training, over the full
  vocab with the positional −1e9 mask, or over each position's ``kary+1``
  valid slots; ``label_head_vectors`` (weight distillation) and
  ``denoise`` (the denoising heads, with ``denoise_disc`` when
  ``ModelConfig.denoising``).

In the train step over a mesh that cuts its leaves (``parallel/mesh.py``;
``mp_mesh`` set), each mp rank computes its part of every product over
them: the embeddings are looked up in this rank's columns and gathered,
``query_proj``, ``fusion`` and ``denoise_disc`` are column-parallel, the
heads tied to ``decode_embed`` / ``shared`` contract over this rank's part
of d and sum the partial logits over the mp row in f32, and an untied
``lm_head`` computes this rank's vocab columns of the full-vocab logits
(the candidate slots, which straddle its parts, read it gathered).

The model's dtype is its parameters' dtype (``model.to(torch.bfloat16)``
serves in bf16).  The model is built in eval mode: dropout runs only after
``model.train()``, as the trainer calls it, and draws from the generator
``models/t5.py::set_dropout_generator`` sets.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.models.deepseek import DeepseekStack
from gdr_tpu_torch.models.kimi_linear import KimiLinearStack
from gdr_tpu_torch.models.pawa import FullPawaAdaptor, PawaAdaptor
from gdr_tpu_torch.models.t5 import Decoder, Encoder, _dense
from gdr_tpu_torch.parallel.autograd import (copy_to_mp, embedding,
                                             gather_from_mp, mp_mesh, mp_part,
                                             reduce_from_mp)
from gdr_tpu_torch.ops.losses import denoising_losses
from gdr_tpu_torch.ops.masks import positional_logit_mask


@functools.lru_cache(maxsize=16)
def _logit_mask(kary: int, max_output_length: int, position: bool,
                device: torch.device) -> torch.Tensor:
    """The [L, V] f32 positional mask on ``device``, made once."""
    return torch.as_tensor(positional_logit_mask(kary, max_output_length,
                                                 position), device=device)


class GenerativeRetriever(nn.Module):
    mp_mesh = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        experts = lambda step: ((c.num_experts, c.expert_capacity, step)
                                if c.num_experts else None)
        if c.decoder_only:
            self.stack = (KimiLinearStack if c.backbone == "kimi_linear"
                          else DeepseekStack)(c)
        else:
            self.encoder = Encoder(
                c.num_layers, c.d_model, c.num_heads, c.d_kv, c.d_ff,
                c.layer_norm_epsilon, c.relative_attention_num_buckets,
                c.relative_attention_max_distance, c.dropout_rate, c.remat,
                experts(c.encoder_sparse_step))
        self.decode_embed = nn.Embedding(c.decode_vocab_size, c.d_model)
        if not c.decoder_only:
            self.decoder = Decoder(
                c.num_decoder_layers, c.d_model, c.num_heads, c.d_kv, c.d_ff,
                c.layer_norm_epsilon, c.relative_attention_num_buckets,
                c.relative_attention_max_distance, c.dropout_rate, c.remat,
                experts(c.decoder_sparse_step))
        if not c.tie_decode_embedding:
            self.lm_head = nn.Parameter(torch.zeros(c.d_model,
                                                    c.decode_vocab_size))
        if c.encoder_d_model != c.d_model:
            self.query_proj = nn.Linear(c.d_model, c.encoder_d_model,
                                        bias=False)
        if c.adaptor_decode:
            pawa_cls = PawaAdaptor if c.adaptor_efficient else FullPawaAdaptor
            self.pawa = pawa_cls(c.d_model, c.decode_vocab_size,
                                 c.adaptor_layer_num, c.adaptor_num_heads,
                                 c.adaptor_d_ff, c.dropout_rate)
        if c.denoising:
            # mask-position discrimination head; the reconstruction head is
            # tied to the shared embedding
            self.denoise_disc = nn.Linear(c.d_model, 2, bias=False)
        if c.concate_fusion:
            # the "concate" query fusion: a biased Dense over [q_dec, q_enc]
            self.fusion = nn.Linear(2 * c.encoder_d_model, c.encoder_d_model)
        self.eval()

    @property
    def dtype(self) -> torch.dtype:
        return self.shared.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def _head_rows(self) -> torch.Tensor:
        """Base lm-head weight as rows [V, d] (tied → decode embeddings);
        an untied head cut over mp is gathered."""
        if self.cfg.tie_decode_embedding:
            return self.decode_embed.weight
        lm = self.lm_head
        if lm.shape[1] != self.cfg.decode_vocab_size:
            lm = gather_from_mp(lm, mp_mesh(self))
        return lm.t()

    def _head_cut(self):
        """The mesh when the base head holds this rank's part of d (tied
        and cut), else None."""
        w = self.decode_embed.weight
        if (not self.cfg.tie_decode_embedding
                or w.shape[1] == self.decode_embed.embedding_dim):
            return None
        return mp_mesh(self)

    def _head_logits(self, s: torch.Tensor) -> torch.Tensor:
        """The base head's logits [..., V] f32 of the head input ``s``."""
        mesh = self._head_cut()
        if mesh is not None:          # the contraction over d, completed
            return reduce_from_mp(mp_part(s, mesh).float()
                                  @ self.decode_embed.weight.float().t(),
                                  mesh)
        lm = None if self.cfg.tie_decode_embedding else self.lm_head
        if lm is not None and lm.shape[1] != self.cfg.decode_vocab_size:
            mesh = mp_mesh(self)      # this rank's vocab columns
            return gather_from_mp(copy_to_mp(s, mesh).float() @ lm.float(),
                                  mesh)
        return s.float() @ self._head_rows().float().t()

    # ---------------------------------------------------------- main paths

    def encode(self, input_ids: torch.Tensor, attn_mask: torch.Tensor):
        return self.prefill(input_ids, attn_mask)[0]

    def prefill(self, input_ids: torch.Tensor, attn_mask: torch.Tensor):
        """(encoder states [B, S, d], the decode's per-query prefix caches:
        None for T5).  The decoder-only stack's states are its final-normed
        states over the query, and its caches the query's keys and
        values."""
        x = embedding(self, self.shared, input_ids)
        if self.cfg.decoder_only:
            return self.stack.prefill(x, attn_mask)
        return self.encoder(x, attn_mask), None

    def query_embedding(self, enc: torch.Tensor,
                        attn_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
        """The dense-stage query rep: T5's first encoder position; the
        decoder-only stack's last real token (``attn_mask`` needed)."""
        if not self.cfg.decoder_only:
            return self.project_query(enc[:, 0])
        last = (attn_mask.long().sum(1) - 1).clamp_min(0)
        return self.project_query(
            enc[torch.arange(enc.shape[0], device=enc.device), last])

    def project_query(self, q: torch.Tensor) -> torch.Tensor:
        if self.cfg.encoder_d_model != self.cfg.d_model:
            q = _dense(self, q, self.query_proj)
        return q

    def pool_query(self, enc: torch.Tensor, decoder_hidden: torch.Tensor,
                   decoder_attn_mask: torch.Tensor) -> torch.Tensor:
        """Dense-stage query rep per ``cfg.query_source``: the encoder's
        first position, the masked mean of the decoder states, or the
        decoder state at the last unmasked (EOS) position."""
        src = self.cfg.query_source
        if src == "encoder":
            q = enc[:, 0]
        elif src == "decoder_avg":
            m = decoder_attn_mask.float()[..., None]
            q = (decoder_hidden * m).sum(1) / m.sum(1).clamp_min(1.0)
        elif src == "decoder_special":
            last = (decoder_attn_mask.long().sum(1) - 1).clamp_min(0)
            q = decoder_hidden[torch.arange(len(last), device=last.device),
                               last]
        else:
            raise ValueError(f"unknown query_source {src}")
        return self.project_query(q)

    def fuse_queries(self, q_dec: torch.Tensor, q_enc: torch.Tensor
                     ) -> torch.Tensor:
        """The learned ``concate`` fusion of decoder-side and encoder query
        reps [..., d'] (broadcast-compatible): the ``fusion`` Dense over
        their concatenation, in the model dtype, its bias added after the
        product is rounded, as ``flax.linen.Dense(dtype=...)``."""
        x = torch.cat([q_dec, q_enc.expand(q_dec.shape)], dim=-1)
        return _dense(self, x, self.fusion) + self.fusion.bias

    # ------------------------------------------------ teacher-forced paths

    def _scaled(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden × d^-0.5 in the model dtype (the reference's weak-typed
        scalar)."""
        return hidden * hidden.new_full((), self.cfg.d_model ** -0.5)

    def decode_hidden(self, enc, enc_mask, decoder_input_ids,
                      decoder_attn_mask) -> torch.Tensor:
        """Decoder states [B, L, d] only (no head)."""
        return self.decoder(embedding(self, self.decode_embed,
                                      decoder_input_ids),
                            enc, decoder_attn_mask, enc_mask)

    def decode_logits(self, enc, enc_mask, decoder_input_ids,
                      decoder_attn_mask, decoder=None):
        """Teacher-forced decode over the full vocab → (masked logits
        [B, L, V] f32, decoder states [B, L, d]).  ``decoder``: a decoder
        stack in place of the model's own (the hierarchic mode's per-depth
        stacks)."""
        c = self.cfg
        x = embedding(self, self.decode_embed, decoder_input_ids)
        dec = self.decoder if decoder is None else decoder
        hidden = dec(x, enc, decoder_attn_mask, enc_mask)
        s = self._scaled(hidden)
        if c.adaptor_decode and not c.adaptor_efficient:
            s_t = self.pawa.transform(self.pawa(decoder_input_ids), s)
            logits = self._head_logits(s_t)
        else:
            logits = self._head_logits(s)
            if c.adaptor_decode:
                logits = logits + self.pawa.delta_logits(self.pawa(x),
                                                         s).float()
        l = logits.shape[1]
        mask = _logit_mask(c.kary, c.max_output_length, c.position,
                           logits.device)
        return logits + mask[None, :l], hidden

    def decode_candidate_logits(self, enc, enc_mask, decoder_input_ids,
                                decoder_attn_mask):
        """Teacher-forced decode over each position's valid slots only:
        its ``kary`` digit tokens, then EOS (the positional mask −1e9s every
        other column, so CE and its gradient equal the full-vocab path's).
        Needs the efficient PAWA head (or none).  Returns (candidate logits
        [B, L, kary+1] f32, decoder states [B, L, d])."""
        c = self.cfg
        kary = c.kary
        if c.adaptor_decode and not c.adaptor_efficient:
            raise ValueError("the candidate-sliced head needs the efficient "
                             "PAWA adaptor")
        x = embedding(self, self.decode_embed, decoder_input_ids)
        hidden = self.decoder(x, enc, decoder_attn_mask, enc_mask)
        s = self._scaled(hidden)
        l = s.shape[1]
        rows = self._head_rows()
        mesh = self._head_cut()
        s_d = s if mesh is None else mp_part(s, mesh)     # this rank's d
        w_dig = rows[2:2 + l * kary].reshape(l, kary, -1)
        cand = torch.einsum("bld,lkd->blk", s_d.float(), w_dig.float())
        eos = (s_d.float() * rows[1].float()).sum(-1)
        cand = torch.cat([cand, eos[..., None]], dim=-1)
        if mesh is not None:
            cand = reduce_from_mp(cand, mesh)
        if c.adaptor_decode:
            cand = cand + self.pawa.delta_candidates_all(self.pawa(x), s,
                                                         kary)
        # the final position admits only EOS
        last = torch.arange(l, device=cand.device) == c.max_output_length - 1
        digit_mask = torch.where(last, -1e9, 0.0)[None, :, None]
        cand = torch.cat([cand[..., :kary] + digit_mask, cand[..., kary:]],
                         dim=-1)
        return cand, hidden

    def forward(self, input_ids, attn_mask, decoder_input_ids,
                decoder_attn_mask, sliced_head: bool = False
                ) -> dict[str, torch.Tensor]:
        """The teacher-forced pass of training: ``logits`` (full-vocab, or
        the candidate slots with ``sliced_head``), ``decoder_hidden``,
        ``encoder_hidden`` and the pooled ``query_embedding``."""
        enc = self.encode(input_ids, attn_mask)
        head = (self.decode_candidate_logits if sliced_head
                else self.decode_logits)
        logits, dec_hidden = head(enc, attn_mask, decoder_input_ids,
                                  decoder_attn_mask)
        return {"logits": logits, "decoder_hidden": dec_hidden,
                "encoder_hidden": enc,
                "query_embedding": self.pool_query(enc, dec_hidden,
                                                   decoder_attn_mask)}

    def label_head_vectors(self, decoder_input_ids, labels) -> torch.Tensor:
        """The adapted lm-head rows of the label tokens (weight
        distillation): base head row + PAWA row, projected into the
        doc-embedding space.  Needs the efficient PAWA head.  [B, L] →
        [B, L, encoder_d_model]."""
        c = self.cfg
        if not (c.adaptor_decode and c.adaptor_efficient):
            raise ValueError("weight distillation needs the efficient PAWA "
                             "adaptor")
        a = self.pawa(embedding(self, self.decode_embed, decoder_input_ids))
        base = self._head_rows()[labels.long()]
        mesh = self._head_cut()
        if mesh is not None:
            base = gather_from_mp(base, mesh)
        return self.project_query(base + self.pawa.label_delta(a, labels))

    def denoise(self, input_ids, attn_mask, keep_mask,
                gumbel: torch.Tensor | None = None,
                generator: torch.Generator | None = None, dp=None):
        """The denoising losses (gen, disc): the reconstruction head is the
        shared embedding, the discrimination head ``denoise_disc``; the
        replacement tokens are argmax(logits + g), ``gumbel`` or drawn from
        ``generator`` (``ops/losses.py::denoising_losses``; ``dp``: this
        rank's share over dp ranks)."""
        def encode(ids):
            return self.encoder(embedding(self, self.shared, ids), attn_mask)

        def predict_head(hidden):
            w = self.shared.weight
            if w.shape[1] == self.shared.embedding_dim:
                return self._scaled(hidden).float() @ w.float().t()
            mesh = mp_mesh(self)      # the contraction over d, completed
            return reduce_from_mp(
                mp_part(self._scaled(hidden), mesh).float() @ w.float().t(),
                mesh)

        def disc_head(hidden):
            return _dense(self, hidden, self.denoise_disc)

        return denoising_losses(encode, predict_head, disc_head, input_ids,
                                attn_mask, keep_mask, gumbel, generator, dp)

    # --------------------------------------------------- incremental decode

    def init_cache(self, enc: torch.Tensor, max_len: int,
                   num_beams: int = 1, prefix: dict | None = None
                   ) -> dict[str, torch.Tensor]:
        """``enc``: un-expanded [B, S, d]; self/PAWA caches get B·K rows,
        cross-attention K/V stay per query (``cross_*`` keys).  ``prefix``:
        :meth:`prefill`'s caches (the decoder-only stack's)."""
        b = enc.shape[0]
        if self.cfg.decoder_only:
            cache = self.stack.init_cache(prefix, max_len, num_beams)
        else:
            cache = self.decoder.init_cache(b, max_len, enc, num_beams)
        if self.cfg.adaptor_decode:
            cache.update(self.pawa.init_cache(b * num_beams, max_len))
        return cache

    def decode_tables(self, max_len: int) -> torch.Tensor:
        """Per-position U candidate slices, built once per weight set."""
        return self.pawa.candidate_table(max_len, self.cfg.kary)

    def decode_step_candidates(self, token: torch.Tensor, cache: dict,
                               enc_mask: torch.Tensor, pos: int,
                               num_beams: int = 1,
                               return_hidden: bool = False):
        """Logits for only the step's candidates: [rows, kary+1] f32
        (digits…, EOS), and the cache.  With the efficient PAWA head the
        delta reads row ``pos`` of the U table (:meth:`decode_tables`),
        which the cache carries as ``cross_ucand``; the slow head transforms
        the head input instead.  ``return_hidden``: also return the decoder
        state [rows, d] after the final norm and before the d^-0.5 scale,
        as (logits, hidden, cache)."""
        c = self.cfg
        kary = c.kary
        x = self.decode_embed(token)[:, None]
        if c.decoder_only:
            hidden, cache = self.stack.decode_step(x[:, 0], cache, pos,
                                                   num_beams)
            hidden = hidden[:, None]
        else:
            hidden, cache = self.decoder.decode_step(x, cache, enc_mask, pos,
                                                     num_beams)
        # × d^-0.5 in the model dtype, as the reference's weak-typed scalar
        s = hidden[:, 0] * hidden.new_full((), c.d_model ** -0.5)
        first = pos * kary + 2
        rows = self._head_rows()
        w_cand = torch.cat([rows[first:first + kary], rows[1:2]], dim=0)
        if c.adaptor_decode and not c.adaptor_efficient:
            a_t, cache = self.pawa.decode_step(token, cache, pos)
            s = self.pawa.transform(a_t[:, 0], s)
        cand = s.float() @ w_cand.float().t()
        if c.adaptor_decode and c.adaptor_efficient:
            a_t, cache = self.pawa.decode_step(x, cache, pos)
            cand = cand + self.pawa.delta_candidates_from_table(
                a_t[:, 0], s, cache["cross_ucand"], pos, kary)
        if pos >= c.max_output_length - 1:   # the last position admits only EOS
            cand[:, :kary] += -1e9
        if return_hidden:
            return cand, hidden[:, 0], cache
        return cand, cache


@torch.no_grad()
def init_weights(model: GenerativeRetriever, generator: torch.Generator
                 ) -> GenerativeRetriever:
    """Seeded random weights with the reference package's initialiser
    scales: embeddings (the slow PAWA head's too), the PAWA memory and the
    experts' routers (``transformers``' Switch initialiser) N(0, 1);
    projections, the experts, rel-bias tables, U, U2 and an untied head
    N(0, 0.02); the query projection, the denoising discriminator and the
    fusion layer N(0, 1/fan_in) (lecun-normal); norm scales 1 and biases
    0; a KDA layer's convolution taps N(0, 0.25), A_log and dt_bias N(0,
    1).  The draws come from ``generator`` on its own device; they are not
    the reference package's draws (use ``convert.py`` for those)."""
    d = model.cfg.d_model
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale" or (leaf == "weight" and ".ln" in name
                               and "pawa" in name):
            p.fill_(1.0)
            continue
        if leaf == "bias":
            p.zero_()
            continue
        if name in ("shared.weight", "decode_embed.weight", "pawa.memory",
                    "pawa.embed.weight") or name.endswith(".ff.router"):
            std = 1.0
        elif name in ("query_proj.weight", "denoise_disc.weight"):
            std = d ** -0.5
        elif name == "fusion.weight":
            std = p.shape[1] ** -0.5
        elif leaf == "conv":
            std = 0.5
        elif leaf in ("A_log", "dt_bias"):
            std = 1.0
        else:
            std = 0.02
        r = torch.randn(p.shape, generator=generator, device=generator.device)
        p.copy_(r * std)
    return model


def shift_right(labels: torch.Tensor, start_token: int = 0) -> torch.Tensor:
    """Labels → decoder inputs: ``start_token`` then labels[:, :-1]."""
    return torch.cat([torch.full_like(labels[:, :1], start_token),
                      labels[:, :-1]], dim=1)
