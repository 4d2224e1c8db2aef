"""PAWA — the per-prefix adaptive lm-head, mirroring ``PawaLayer``,
``PawaAdaptor`` (the "efficient" variant) and ``FullPawaAdaptor`` (the slow
one) of ``gdr_tpu/models/pawa.py``.

A small post-norm transformer decoder runs over the decode embeddings of
the emitted prefix, cross-attending to one learned memory token; its output
A contracts with U [d, V, d] into an additive delta on the lm-head logits.
The decode path only ever needs each position's ``kary`` digit blocks of U
plus the EOS block, so :meth:`PawaAdaptor.candidate_table` stacks those
slices once per weight set and each step contracts against one row of the
stack.  Plain PyTorch throughout: the reference package runs this adaptor
as XLA code (its fused kernels were measured slower and deleted).

The slow :class:`FullPawaAdaptor` runs the same layers over its own
embedding of the prefix tokens and a zero memory, and turns its output into
a per-prefix [d, d] matrix reshape(A·U2) that transforms the head input.

The teacher-forced paths (``forward`` over all ``L`` positions, the full
vocab's ``delta_logits``, the candidate slots' ``delta_candidates_all``
and the label tokens' ``label_delta``) train U and U2 by autograd; the
layers' dropout is the reference's (``models/t5.py::Dropout``).  In the
train step over a mesh that cuts them (``parallel/mesh.py``), the layers'
linears are column-parallel as T5's, ``embed`` is looked up in this rank's
columns and gathered, and U and U2 hold this rank's part of their last
axis: the contractions over that axis (the delta's with the decoder state,
the transform's with the head input) are this rank's partial sums, summed
over the mp row in f32 and cast once; ``label_delta``'s output columns
are gathered.
"""

from __future__ import annotations

import torch
from torch import nn

from gdr_tpu_torch.models.t5 import Attention, Dropout, _dense, _linear
from gdr_tpu_torch.parallel.autograd import (copy_to_mp, embedding,
                                             gather_from_mp, mp_mesh, mp_part,
                                             reduce_from_mp)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` numerics: f32 statistics with the fast
    variance E[x²]−E[x]², scale folded into the rsqrt, result in the model
    dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = (mu2 - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mu) * mul + self.bias.float()
        return y.to(self.weight.dtype)


class PawaLayer(nn.Module):
    """One adaptor block: causal self-attn → cross-attn(memory) → FF,
    post-norm residuals."""

    mp_mesh = None

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        d_kv = d_model // num_heads
        self.self_attn = Attention(d_model, num_heads, d_kv, dropout_rate)
        self.cross_attn = Attention(d_model, num_heads, d_kv, dropout_rate)
        self.ln1 = LayerNorm(d_model)
        self.ln2 = LayerNorm(d_model)
        self.ln3 = LayerNorm(d_model)
        self.ff1 = nn.Linear(d_model, d_ff, bias=False)
        self.ff2 = nn.Linear(d_ff, d_model, bias=False)
        self.drop = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """All positions at once: x [B, L, d], memory [B, 1, d].  The
        cross-attention runs in full, as the reference's does, so that its
        probabilities get their dropout."""
        l = x.shape[1]
        causal = torch.ones((l, l), dtype=torch.bool,
                            device=x.device).tril()[None, None]
        x = self.ln1(x + self.drop(self.self_attn(x, mask=causal)))
        x = self.ln2(x + self.drop(self.cross_attn(x, kv=memory)))
        h = _dense(self, torch.relu(_dense(self, x, self.ff1)), self.ff2)
        return self.ln3(x + self.drop(h))

    def memory_out(self, memory: torch.Tensor) -> torch.Tensor:
        """Cross-attention to a single memory token is query-independent
        (softmax over one key is 1): the sublayer output is o(v(memory))."""
        return _linear(_linear(memory, self.cross_attn.wv),
                       self.cross_attn.o.weight)

    def decode_step(self, x_t, cache_k, cache_v, mem_out, pos: int):
        h, cache_k, cache_v = self.self_attn.decode_step(
            x_t, cache_k, cache_v, pos)
        x_t = self.ln1(x_t + h)
        x_t = self.ln2(x_t + mem_out)
        h = _linear(torch.relu(_linear(x_t, self.ff1.weight)), self.ff2.weight)
        return self.ln3(x_t + h), cache_k, cache_v


def _pawa_cache(num_layers: int, batch: int, max_len: int,
                param: torch.Tensor) -> dict[str, torch.Tensor]:
    """Time-major [Lmax, rows, d] self-attention caches of an adaptor's
    layers, in the dtype and on the device of ``param`` (its [d, ...]
    weight-delta tensor)."""
    cache = {}
    for i in range(num_layers):
        cache[f"tm_pawa_k_{i}"] = torch.zeros(
            (max_len, batch, param.shape[0]), dtype=param.dtype,
            device=param.device)
        cache[f"tm_pawa_v_{i}"] = torch.zeros_like(cache[f"tm_pawa_k_{i}"])
    return cache


# bytes of the f32 A·U2 rows FullPawaAdaptor.transform holds at once
_TRANSFORM_CHUNK_BYTES = 1 << 30


class FullPawaAdaptor(nn.Module):
    """The slow PAWA variant (``adaptor_efficient=False``): the adaptor
    stack over its own ``embed`` table emits per position a [d, d]
    transform reshape(A·U2) of the head input, s' = s · reshape(A·U2, [d,
    d]); the base lm-head is then applied to s'."""

    mp_mesh = None

    def __init__(self, d_model: int, decode_vocab_size: int,
                 num_layers: int = 4, num_heads: int = 8, d_ff: int = 0,
                 dropout_rate: float = 0.0):
        super().__init__()
        d_ff = d_ff or min(4 * d_model, 2048)
        self.d_model = d_model
        self.embed = nn.Embedding(decode_vocab_size, d_model)
        self.layers = nn.ModuleList([
            PawaLayer(d_model, num_heads, d_ff, dropout_rate)
            for _ in range(num_layers)])
        self.u2 = nn.Parameter(torch.zeros(d_model, d_model * d_model))

    def forward(self, decoder_input_ids: torch.Tensor) -> torch.Tensor:
        """The adaptor over all positions of the prefix tokens [B, L]:
        A [B, L, d] scaled by d^-0.5 in the model dtype."""
        x = embedding(self, self.embed, decoder_input_ids)
        zero = x.new_zeros((x.shape[0], 1, self.d_model))
        for layer in self.layers:
            x = layer(x, zero)
        return x * x.new_full((), self.d_model ** -0.5)

    def init_cache(self, batch: int, max_len: int) -> dict[str, torch.Tensor]:
        return _pawa_cache(len(self.layers), batch, max_len, self.u2)

    def decode_step(self, token: torch.Tensor, cache: dict, pos: int):
        """One incremental step on the prefix token ids [rows]: returns
        (A [rows, 1, d] scaled by d^-0.5 in the model dtype, cache).  The
        memory is zero, and cross-attention to it through biasless
        projections is exactly 0."""
        x = self.embed(token)[:, None]
        zero = x.new_zeros((1, 1, self.d_model))
        cache = dict(cache)
        for i, layer in enumerate(self.layers):
            x, ck, cv = layer.decode_step(
                x, cache[f"tm_pawa_k_{i}"], cache[f"tm_pawa_v_{i}"], zero, pos)
            cache[f"tm_pawa_k_{i}"] = ck
            cache[f"tm_pawa_v_{i}"] = cv
        return x * x.new_full((), self.d_model ** -0.5), cache

    def transform(self, adaptor_out: torch.Tensor, decoder_out: torch.Tensor
                  ) -> torch.Tensor:
        """s' = s · reshape(A·U2, [d, d]) per row.  A, s: [rows, d] (or
        [B, L, d], each position a row) in the model dtype.  A·U2 is kept in f32 (``preferred_element_type=f32``
        in the reference): the operands go to f32, where the product of two
        bf16 values is exact, and the sums run in f32.  Rows go in chunks so
        that the f32 [rows, d, d] matrices stay within 1 GiB.  Returns
        [rows, d] in the model dtype."""
        d = self.d_model
        shape = decoder_out.shape
        adaptor_out = adaptor_out.reshape(-1, d)
        decoder_out = decoder_out.reshape(-1, d)
        u2 = self.u2.float()
        mesh = None
        if u2.shape[1] != d * d:
            # this rank's rows of each [d, d] transform: its part of s
            mesh = mp_mesh(self)
            adaptor_out = copy_to_mp(adaptor_out, mesh)
            decoder_out = mp_part(decoder_out, mesh)
        rows = u2.shape[1] // d
        step = max(1, _TRANSFORM_CHUNK_BYTES // (4 * d * d))
        out = []
        for i in range(0, adaptor_out.shape[0], step):
            w = (adaptor_out[i:i + step].float() @ u2).view(-1, rows, d)
            s = decoder_out[i:i + step].float()[:, None]
            t = torch.bmm(s, w)[:, 0]
            out.append(t if mesh else t.to(decoder_out.dtype))
        if mesh:
            return reduce_from_mp(torch.cat(out), mesh).to(
                decoder_out.dtype).reshape(shape)
        return torch.cat(out).reshape(shape)


class PawaAdaptor(nn.Module):
    """The adaptor stack plus the weight-delta tensor U [d, V, d]."""

    mp_mesh = None

    def __init__(self, d_model: int, decode_vocab_size: int,
                 num_layers: int = 4, num_heads: int = 8, d_ff: int = 0,
                 dropout_rate: float = 0.0):
        super().__init__()
        d_ff = d_ff or min(4 * d_model, 2048)
        self.d_model = d_model
        self.memory = nn.Parameter(torch.zeros(1, 1, d_model))
        self.layers = nn.ModuleList([
            PawaLayer(d_model, num_heads, d_ff, dropout_rate)
            for _ in range(num_layers)])
        self.u = nn.Parameter(torch.zeros(d_model, decode_vocab_size, d_model))

    def forward(self, decode_embeds: torch.Tensor) -> torch.Tensor:
        """The adaptor over all positions: decode_embeds [B, L, d] (the
        embedded decoder inputs) → A [B, L, d]."""
        x = decode_embeds
        memory = self.memory
        if memory.shape[-1] != self.d_model:
            memory = gather_from_mp(memory, mp_mesh(self))
        memory = memory.expand(x.shape[0], 1, self.d_model)
        for layer in self.layers:
            x = layer(x, memory)
        return x

    def delta_logits(self, adaptor_out: torch.Tensor,
                     decoder_out: torch.Tensor) -> torch.Tensor:
        """Σ_ij A[..,j]·s[..,i]·U[j,v,i] for the whole vocab, all positions
        in one pass over U: G = A·U as one [B·L, d]·[d, V·d] product in the
        model dtype, then each position's G dotted with s in f32.  A, s
        [B, L, d] → [B, L, V] in the model dtype."""
        d = self.d_model
        b, l, _ = adaptor_out.shape
        u_flat = self.u.reshape(d, -1)
        mesh = self._cut()
        if mesh is None:
            g = (adaptor_out.reshape(b * l, d) @ u_flat).reshape(b, l, -1, d)
            return torch.einsum("blvi,bli->blv", g.float(),
                                decoder_out.float()).to(adaptor_out.dtype)
        g = (copy_to_mp(adaptor_out, mesh).reshape(b * l, d)
             @ u_flat).reshape(b, l, -1, self.u.shape[-1])
        part = torch.einsum("blvi,bli->blv", g.float(),
                            mp_part(decoder_out, mesh).float())
        return reduce_from_mp(part, mesh).to(adaptor_out.dtype)

    def _cut(self):
        """The mesh when U holds this rank's part of its last axis."""
        return None if self.u.shape[-1] == self.d_model else mp_mesh(self)

    def label_delta(self, adaptor_out: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
        """The PAWA rows of the label tokens: Δ[b,l,i] = Σ_j A[b,l,j] ·
        U[j, labels[b,l], i], in f32 then rounded to the model dtype.  One
        position at a time, so the gathered U stays [d, B, d].  A [B, L, d],
        labels [B, L] → [B, L, d]."""
        mesh = self._cut()
        if mesh is not None:
            adaptor_out = copy_to_mp(adaptor_out, mesh)
        out = [torch.einsum("bj,jbi->bi", adaptor_out[:, l].float(),
                            self.u[:, labels[:, l].long()].float())
               for l in range(labels.shape[1])]
        out = torch.stack(out, dim=1).to(adaptor_out.dtype)
        return out if mesh is None else gather_from_mp(out, mesh)

    def delta_candidates_all(self, adaptor_out: torch.Tensor,
                             decoder_out: torch.Tensor, kary: int
                             ) -> torch.Tensor:
        """The teacher-forced candidate deltas of every position at once:
        position l's digit blocks of U are the contiguous tokens
        l·kary+2 …, so they stack into one [d, L, kary·d] view and the delta
        is an L-batched [B, d]·[d, kary·d] product (model dtype), dotted
        with s in f32; the EOS block likewise.  A, s [B, L, d] → [B, L,
        kary+1] f32 (digit slots, EOS)."""
        d = self.d_model
        b, l, _ = adaptor_out.shape
        c = self.u.shape[-1]                 # d, or this rank's part of it
        mesh = self._cut()
        if mesh is not None:
            adaptor_out = copy_to_mp(adaptor_out, mesh)
            decoder_out = mp_part(decoder_out, mesh)
        u_dig = self.u[:, 2:2 + l * kary, :].reshape(d, l, kary * c)
        g = torch.einsum("bli,ilk->blk", adaptor_out, u_dig)
        dig = torch.einsum("blkd,bld->blk", g.reshape(b, l, kary, c).float(),
                           decoder_out.float())
        ae = adaptor_out @ self.u[:, 1, :]                      # EOS block
        eos = (ae.float() * decoder_out.float()).sum(-1)
        out = torch.cat([dig, eos[..., None]], dim=-1)
        return out if mesh is None else reduce_from_mp(out, mesh)

    def init_cache(self, batch: int, max_len: int) -> dict[str, torch.Tensor]:
        return _pawa_cache(len(self.layers), batch, max_len, self.u)

    def decode_step(self, embed_t: torch.Tensor, cache: dict, pos: int):
        """One incremental adaptor step.  embed_t: [rows, 1, d]."""
        cache = dict(cache)
        x = embed_t
        for i, layer in enumerate(self.layers):
            x, ck, cv = layer.decode_step(
                x, cache[f"tm_pawa_k_{i}"], cache[f"tm_pawa_v_{i}"],
                layer.memory_out(self.memory), pos)
            cache[f"tm_pawa_k_{i}"] = ck
            cache[f"tm_pawa_v_{i}"] = cv
        return x, cache

    def _candidate_slice(self, first: int, kary: int) -> torch.Tensor:
        """The digit blocks ``U[:, first : first+kary, :]`` and the EOS
        block, flattened to [d, (kary+1)·d]."""
        idx = list(range(first, first + kary)) + [1]
        return self.u[:, idx, :].reshape(self.d_model, (kary + 1) * self.d_model)

    def candidate_table(self, max_len: int, kary: int) -> torch.Tensor:
        """Per-position candidate slices of U: row l is the slice of
        position l (first digit token l·kary+2).  Returns
        [max_len, d, (kary+1)·d] in the model dtype."""
        return torch.stack([self._candidate_slice(l * kary + 2, kary)
                            for l in range(max_len)])

    def delta_candidates_from_table(self, adaptor_out, decoder_out, table,
                                    pos: int, kary: int) -> torch.Tensor:
        """Delta logits of the step's candidate tokens (its digits, then
        EOS) against row ``pos`` of :meth:`candidate_table`: [rows, kary+1]
        f32.  g = A·U_cand in the model dtype (the reference's
        preferred_element_type), the final contraction with the decoder
        state in f32."""
        g = (adaptor_out @ table[pos]).reshape(adaptor_out.shape[0], kary + 1,
                                               self.d_model)
        return torch.einsum("bvi,bi->bv", g.float(), decoder_out.float())
