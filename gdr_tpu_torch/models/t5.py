"""T5 encoder-decoder in PyTorch, mirroring ``gdr_tpu/models/t5.py``.

RMS layer norm, relative position bias (one table per stack, plus the
decoder cross-attention's own bidirectional table), pre-norm blocks, ReLU
feed-forward, no biases, no 1/√d_kv scaling.  Rounding points follow the
reference package: matmul inputs in the model dtype with f32 accumulation
for attention scores, f32 softmax, probabilities rounded to the model dtype
before the value product.  The model dtype is the parameters' dtype.

Attention weights are one fused ``qkv`` Linear (``[3·inner, d]``); q, k and v
are its contiguous row slices, so the decoder's fused-QKV kernel and the
cross-attention's separate Q / K / V projections read the same storage.

The decoder's incremental :meth:`Decoder.decode_step` runs every sublayer
through the wrappers of ``kernels/decode.py``: the hand-written CUDA
kernels for CUDA tensors, their plain versions on the CPU.  Caches are
time-major ``[L, rows, H·d_kv]`` for self-attention (``tm_*`` keys, reordered
by the beam search along axis 1) and per query ``[B, H, S, d_kv]`` for
cross-attention (``cross_*`` keys, never reordered).

The full-sequence paths (``Encoder.forward``, the teacher-forced
``Decoder.forward``) are plain PyTorch, as in the reference package, which
trains outside any Pallas kernel.  In the train step over a mesh whose mp
row cuts a weight (``parallel/mesh.py``; the module's ``mp_mesh`` set),
the module holds this rank's rows of it and computes its columns only
(``parallel/autograd.py::column_linear``): the fused ``qkv``, ``o``,
``wi`` and ``wo``.  Where the heads divide over the row, a rank's q, k and
v heads stay local through the scores, softmax and value product and the
context is gathered before ``o``; otherwise q, k and v are gathered before
the core.  They have a :class:`Dropout` at every
place flax has one: attention probabilities, the FFN hidden, each block's
residual branches and the stack's input and output.  Dropout runs only in
train mode and draws from a ``torch.Generator`` the caller sets
(:func:`set_dropout_generator`).  ``remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``), with the same dropout draws.

A stack built with ``experts`` (Switch Transformer: ``ModelConfig``'s
``num_experts`` > 0) has a :class:`RoutedFeedForward` in place of the FFN
at its sparse layers: RMSNorm, an f32 router, each token's top expert and
its probability π, a capacity per sequence and x + π·expert(h), through
``kernels/experts.py::expert_sublayer`` on every path (the CUDA kernels
for CUDA tensors, the plain version on the CPU).  Its cached decode keeps
each beam's tokens per expert (``moe_count_<i>`` cache entries, reordered
with the beams), so that capacity counts the beam's whole prefix, as a
decoder recomputed over it does.  Routed layers serve only: in train mode
they raise (the router's z-loss and load-balancing loss are not ported).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gdr_tpu_torch.kernels.decode import (cross_attn_sublayer, ffn_sublayer,
                                          self_attn_sublayer)
from gdr_tpu_torch.kernels.experts import expert_sublayer
from gdr_tpu_torch.parallel.autograd import (column_linear, copy_to_mp,
                                             gather_from_mp, mp_mesh, mp_part)
from gdr_tpu_torch.utils.timing import span

NEG_INF = -1e9


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense in the model dtype (``flax.linen.Dense(dtype=...)``)."""
    return torch.nn.functional.linear(x.to(w.dtype), w)


def _dense(module: nn.Module, x: torch.Tensor, lin: nn.Linear,
           blocks: int = 1) -> torch.Tensor:
    """:func:`_linear` by ``module``'s Linear ``lin``; column-parallel over
    the module's mesh where ``lin`` holds this rank's rows of its weight."""
    w = lin.weight
    if w.shape[0] == lin.out_features:
        return _linear(x, w)
    return column_linear(x.to(w.dtype), w, mp_mesh(module), blocks)


class Dropout(nn.Module):
    """``flax.linen.Dropout``: in train mode each element is kept with
    probability 1 − p and scaled by 1 / (1 − p), else zeroed; in eval mode
    or at p = 0 the identity.  The draws come from ``generator``, set for
    the whole model by :func:`set_dropout_generator`."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor, part=None) -> torch.Tensor:
        """``part``: (mesh, dim) when ``x`` is this mp rank's part of a
        tensor cut on ``dim``; the draws are the whole tensor's, so that the
        mask is the one of an uncut step."""
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in train mode draws from a generator:"
                               " call set_dropout_generator(model, gen)")
        keep_prob = 1.0 - self.p
        if part is None:
            u = torch.rand(x.shape, generator=self.generator,
                           device=x.device)
        else:
            mesh, dim = part
            shape, n = list(x.shape), x.shape[dim]
            shape[dim] = n * mesh.mp
            u = torch.rand(shape, generator=self.generator,
                           device=x.device).narrow(dim, mesh.mp_rank * n, n)
        return torch.where(u < keep_prob, x / keep_prob,
                           torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Every :class:`Dropout` of ``module`` draws from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def _run_blocks(blocks, remat: bool, x, *args):
    """x through each block; with ``remat`` (and autograd recording) each
    block is recomputed in the backward pass, its dropout generator reset
    to the state the forward drew from, so that the recomputation draws
    the same masks."""
    for blk in blocks:
        if not (remat and torch.is_grad_enabled()):
            x = blk(x, *args)
            continue
        gen = blk.drop.generator
        state = gen.get_state() if gen is not None else None

        def run(*a, blk=blk, gen=gen, state=state):
            if state is not None:
                gen.set_state(state)
            return blk(*a)
        x = checkpoint(run, x, *args, use_reentrant=False)
    return x


class RMSNorm(nn.Module):
    """T5 layer norm: no mean subtraction, no bias."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(self.scale.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5 log-bucketing of relative positions (mem_pos - query_pos), in f32
    exactly as the reference package computes it (a one-ulp difference in
    the log moves a bias row)."""
    rel = relative_position.to(torch.int32)
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    scaled = torch.log(n.to(torch.float32) / f32(max_exact) + f32(1e-6))
    scaled = scaled / torch.log(f32(max_distance / max_exact))
    scaled = scaled * f32(num_buckets - max_exact)
    val_if_large = max_exact + scaled.to(torch.int32)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


@functools.lru_cache(maxsize=256)
def _buckets(qlen: int, klen: int, q_offset: int, bidirectional: bool,
             num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bucket ids [qlen, klen], computed once on the host (whatever the
    default device of the caller)."""
    with torch.device("cpu"):
        context = torch.arange(qlen)[:, None] + q_offset
        memory = torch.arange(klen)[None, :]
        return relative_position_bucket(memory - context, bidirectional,
                                        num_buckets, max_distance).long()


class RelativePositionBias(nn.Module):
    mp_mesh = None

    def __init__(self, num_heads: int, num_buckets: int = 32,
                 max_distance: int = 128, bidirectional: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.bidirectional = bidirectional
        self.rel_embedding = nn.Parameter(torch.zeros(num_buckets, num_heads))
        self._ids: dict = {}

    def bucket_ids(self, qlen: int, klen: int, q_offset: int,
                   device: torch.device) -> torch.Tensor:
        """The bucket ids [qlen, klen] on ``device``, copied there once:
        a copy from the host cannot be captured in a CUDA graph."""
        key = (qlen, klen, int(q_offset), device)
        ids = self._ids.get(key)
        if ids is None:
            ids = self._ids[key] = _buckets(
                qlen, klen, int(q_offset), self.bidirectional,
                self.num_buckets, self.max_distance).to(device)
        return ids

    def forward(self, qlen: int, klen: int, q_offset: int = 0) -> torch.Tensor:
        """Bias [1, heads, qlen, klen] in the model dtype."""
        table = self.rel_embedding
        if table.shape[1] != self.num_heads:          # cut on the heads
            table = gather_from_mp(table, mp_mesh(self), dim=1)
        bias = table[self.bucket_ids(qlen, klen, q_offset, table.device)]
        return bias.permute(2, 0, 1)[None]


class Attention(nn.Module):
    """Multi-head attention with an optional explicit KV cache."""

    mp_mesh = None

    def __init__(self, d_model: int, num_heads: int, d_kv: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.d_kv = d_kv
        self.inner = num_heads * d_kv
        self.qkv = nn.Linear(d_model, 3 * self.inner, bias=False)
        self.o = nn.Linear(self.inner, d_model, bias=False)
        self.attn_dropout = Dropout(dropout_rate)

    @property
    def wq(self) -> torch.Tensor:
        n = self.qkv.weight.shape[0] // 3
        return self.qkv.weight[:n]

    @property
    def wk(self) -> torch.Tensor:
        n = self.qkv.weight.shape[0] // 3
        return self.qkv.weight[n:2 * n]

    @property
    def wv(self) -> torch.Tensor:
        n = self.qkv.weight.shape[0] // 3
        return self.qkv.weight[2 * n:]

    @property
    def dtype(self) -> torch.dtype:
        return self.qkv.weight.dtype

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, l, n = x.shape
        return x.reshape(b, l, n // self.d_kv, self.d_kv).transpose(1, 2)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def _core(self, q, k, v, mask, bias, part=None):
        """Scores, softmax, dropout and value product over the heads of q,
        k, v [B, h, L, d_kv] (``part``: the dropout's, when they are this
        mp rank's heads) → the merged context [B, L, h·d_kv]."""
        scores = q.float() @ k.float().transpose(-1, -2)
        if bias is not None:
            scores = scores + bias.float()
        if mask is not None:
            scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        probs = self.attn_dropout(torch.softmax(scores, dim=-1).to(self.dtype),
                                  part)
        return self._merge(probs @ v)

    def _context_mp(self, x, kv, mask, bias):
        """The context [B, L, inner] when ``qkv`` holds this mp rank's rows
        of q, k and v: its heads' core where the heads divide over the row
        (the bias cut to them), else the whole core after a gather."""
        mesh = mp_mesh(self)
        x = copy_to_mp(x.to(self.dtype), mesh)
        if kv is None:
            q, k, v = F.linear(x, self.qkv.weight).split(
                self.qkv.weight.shape[0] // 3, dim=-1)
        else:
            kv = copy_to_mp(kv.to(self.dtype), mesh)
            q = F.linear(x, self.wq)
            k, v = F.linear(kv, self.wk), F.linear(kv, self.wv)
        if self.num_heads % mesh.mp:
            q, k, v = (gather_from_mp(t, mesh) for t in (q, k, v))
            return self._core(self._split(q), self._split(k), self._split(v),
                              mask, bias)
        if bias is not None:
            bias = mp_part(bias, mesh, dim=1)
        ctx = self._core(self._split(q), self._split(k), self._split(v),
                         mask, bias, part=(mesh, 1))
        return gather_from_mp(ctx, mesh)

    def forward(self, x, kv=None, mask=None, bias=None):
        """Full attention over ``x``, or over ``kv`` (cross-attention).
        mask: broadcastable to [B, 1, Q, K], True = attend."""
        if self.qkv.weight.shape[0] != 3 * self.inner:
            ctx = self._context_mp(x, kv, mask, bias)
        else:
            if kv is None:
                q, k, v = _linear(x, self.qkv.weight).split(self.inner,
                                                            dim=-1)
            else:
                q = _linear(x, self.wq)
                k, v = _linear(kv, self.wk), _linear(kv, self.wv)
            ctx = self._core(self._split(q), self._split(k), self._split(v),
                             mask, bias)
        return _dense(self, ctx, self.o)

    def precompute_kv(self, kv_src: torch.Tensor):
        """Project a cross-attention source once: ([B,H,S,dk], [B,H,S,dk])."""
        return (self._split(_linear(kv_src, self.wk)).contiguous(),
                self._split(_linear(kv_src, self.wv)).contiguous())

    def decode_step(self, x_t, cache_k, cache_v, pos: int):
        """One-token causal self-attention against time-major caches
        [Lmax, rows, inner]: this token's k/v are written at ``pos`` (in
        place) and attention spans positions ≤ pos, with no position bias.
        The PAWA adaptor's layers run it; the T5 decoder runs the sublayer
        kernels of ``kernels/decode.py`` instead.
        Returns (out [rows, 1, d], cache_k, cache_v)."""
        inner = self.inner
        qkv = _linear(x_t[:, 0], self.qkv.weight)         # [rows, 3·inner]
        q = qkv[:, :inner].reshape(-1, self.num_heads, self.d_kv)
        cache_k[pos] = qkv[:, inner:2 * inner]
        cache_v[pos] = qkv[:, 2 * inner:]
        lmax = cache_k.shape[0]
        k = cache_k.reshape(lmax, -1, self.num_heads, self.d_kv)
        v = cache_v.reshape(lmax, -1, self.num_heads, self.d_kv)
        scores = torch.einsum("rhd,lrhd->rhl", q.float(), k.float())
        causal = torch.arange(lmax, device=scores.device) <= pos
        scores = torch.where(causal, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.einsum("rhl,lrhd->rhd", probs, v).reshape(-1, 1, inner)
        return _linear(out, self.o.weight), cache_k, cache_v


class FeedForward(nn.Module):
    mp_mesh = None

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0):
        super().__init__()
        self.wi = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)
        self.drop = Dropout(dropout_rate)

    def forward(self, x):
        h = self.drop(torch.relu(_dense(self, x, self.wi)))
        return _dense(self, h, self.wo)


class RoutedFeedForward(nn.Module):
    """A top-1 routed mixture of ReLU experts (``transformers``'
    ``SwitchTransformersSparseMLP`` with its ``Top1Router``): the router
    ``[E, d]`` (no bias), the stacked experts ``wi [E, d_ff, d]`` and
    ``wo [E, d, d_ff]``.  Each token of a sequence goes to the expert of
    its largest router logit, scaled by that expert's softmax probability,
    unless ``capacity`` earlier tokens of its sequence went there: then it
    adds 0."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 capacity: int):
        super().__init__()
        self.capacity = capacity
        self.router = nn.Parameter(torch.zeros(num_experts, d_model))
        self.wi = nn.Parameter(torch.zeros(num_experts, d_ff, d_model))
        self.wo = nn.Parameter(torch.zeros(num_experts, d_model, d_ff))

    def residual(self, x: torch.Tensor, norm: RMSNorm,
                 counts: torch.Tensor | None = None) -> torch.Tensor:
        """x + π·expert(norm(x)) of x [B, L, d], capacity counted over each
        of the B sequences (and ``counts`` [B, E] of earlier tokens, which
        this call's tokens are added to in place)."""
        if self.training:
            raise NotImplementedError(
                "sparse experts serve only: the router's z-loss and "
                "load-balancing loss of training are not ported")
        b, l, d = x.shape
        with span("gdr.moe", f"rows={b * l} k=1"):
            out = expert_sublayer(x.reshape(b * l, d), norm.scale, self.router,
                                  self.wi, self.wo, capacity=self.capacity,
                                  seq_len=l, counts=counts, eps=norm.eps)
        return out.view(b, l, d)


def _ffn(d_model, d_ff, dropout_rate, experts):
    """The block's FFN: routed over ``experts`` (number, capacity), or
    dense."""
    if experts:
        return RoutedFeedForward(d_model, d_ff, *experts)
    return FeedForward(d_model, d_ff, dropout_rate)


class EncoderBlock(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, d_ff, eps=1e-6,
                 dropout_rate=0.0, experts=None):
        super().__init__()
        self.ln1 = RMSNorm(d_model, eps)
        self.attn = Attention(d_model, num_heads, d_kv, dropout_rate)
        self.ln2 = RMSNorm(d_model, eps)
        self.ff = _ffn(d_model, d_ff, dropout_rate, experts)
        self.drop = Dropout(dropout_rate)

    def forward(self, x, mask, bias):
        x = x + self.drop(self.attn(self.ln1(x), mask=mask, bias=bias))
        if isinstance(self.ff, RoutedFeedForward):
            return self.ff.residual(x, self.ln2)
        return x + self.drop(self.ff(self.ln2(x)))


class DecoderBlock(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, d_ff, eps=1e-6,
                 dropout_rate=0.0, experts=None):
        super().__init__()
        self.eps = eps
        self.ln1 = RMSNorm(d_model, eps)
        self.self_attn = Attention(d_model, num_heads, d_kv, dropout_rate)
        self.ln2 = RMSNorm(d_model, eps)
        self.cross_attn = Attention(d_model, num_heads, d_kv, dropout_rate)
        self.ln3 = RMSNorm(d_model, eps)
        self.ff = _ffn(d_model, d_ff, dropout_rate, experts)
        self.drop = Dropout(dropout_rate)

    @property
    def routed(self) -> bool:
        return isinstance(self.ff, RoutedFeedForward)

    def forward(self, x, enc, self_mask, cross_mask, bias, cross_bias):
        """Teacher-forced block over x [B, L, d] and the encoder output
        enc [B, S, d]."""
        h = self.self_attn(self.ln1(x), mask=self_mask, bias=bias)
        x = x + self.drop(h)
        h = self.cross_attn(self.ln2(x), kv=enc, mask=cross_mask,
                            bias=cross_bias)
        x = x + self.drop(h)
        if self.routed:
            return self.ff.residual(x, self.ln3)
        return x + self.drop(self.ff(self.ln3(x)))

    def decode_step(self, x, self_k, self_v, cross_k, cross_v, pos: int,
                    bias_self, cross_bias, num_beams: int, counts=None):
        """One step of this block on x [rows, d] through the three sublayer
        wrappers.  bias_self: [L, H] f32; cross_bias: [B, H, S] f32 (rel-bias
        row + −1e9 at pads).  The self caches are written at ``pos`` in
        place; so are ``counts`` [rows, E], each row's earlier tokens per
        expert, where the FFN is routed."""
        a = self.self_attn
        x, self_k, self_v = self_attn_sublayer(
            x, pos, self.ln1.scale, a.qkv.weight, a.o.weight, bias_self,
            self_k, self_v, heads=a.num_heads, d_kv=a.d_kv, eps=self.eps)
        c = self.cross_attn
        x = cross_attn_sublayer(
            x, self.ln2.scale, c.wq, c.o.weight, cross_k, cross_v, cross_bias,
            num_beams, heads=c.num_heads, d_kv=c.d_kv, eps=self.eps)
        if self.routed:
            x = self.ff.residual(x[:, None], self.ln3, counts)[:, 0]
        else:
            x = ffn_sublayer(x, self.ln3.scale, self.ff.wi.weight,
                             self.ff.wo.weight, eps=self.eps)
        return x, self_k, self_v


def is_sparse(i: int, step: int) -> bool:
    """Whether layer ``i`` of a stack with sparse step ``step`` routes its
    FFN over experts (``transformers``' ``SwitchTransformersStack``: every
    layer at step 1, none at step 0)."""
    return step > 0 and (step == 1 or i % step == 1)


def _experts_at(experts, num_layers: int):
    """Each layer's (number, capacity) of experts, or None where it is
    dense; ``experts``: (number, capacity, the sparse step) or None."""
    if not experts:
        return [None] * num_layers
    n, capacity, step = experts
    return [(n, capacity) if is_sparse(i, step) else None
            for i in range(num_layers)]


class Encoder(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, d_kv, d_ff, eps=1e-6,
                 num_buckets=32, max_distance=128, dropout_rate=0.0,
                 remat=False, experts=None):
        super().__init__()
        self.remat = remat
        self.rel_bias = RelativePositionBias(num_heads, num_buckets,
                                             max_distance, bidirectional=True)
        self.blocks = nn.ModuleList([
            EncoderBlock(d_model, num_heads, d_kv, d_ff, eps, dropout_rate, e)
            for e in _experts_at(experts, num_layers)])
        self.final_norm = RMSNorm(d_model, eps)
        self.drop = Dropout(dropout_rate)

    def forward(self, x, attn_mask):
        """x: embedded inputs [B, L, d]; attn_mask: [B, L] (1 = token)."""
        l = x.shape[1]
        bias = self.rel_bias(l, l)
        mask = attn_mask[:, None, None, :].bool()
        x = _run_blocks(self.blocks, self.remat, self.drop(x), mask, bias)
        return self.drop(self.final_norm(x))


class Decoder(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, d_kv, d_ff, eps=1e-6,
                 num_buckets=32, max_distance=128, dropout_rate=0.0,
                 remat=False, experts=None):
        super().__init__()
        self.remat = remat
        self.num_heads = num_heads
        self.d_kv = d_kv
        self.rel_bias = RelativePositionBias(num_heads, num_buckets,
                                             max_distance, bidirectional=False)
        # the HF-3.4-era T5 the reference trains also biases cross-attention,
        # with its own bidirectional table
        self.cross_rel_bias = RelativePositionBias(
            num_heads, num_buckets, max_distance, bidirectional=True)
        self.blocks = nn.ModuleList([
            DecoderBlock(d_model, num_heads, d_kv, d_ff, eps, dropout_rate, e)
            for e in _experts_at(experts, num_layers)])
        self.final_norm = RMSNorm(d_model, eps)
        self.drop = Dropout(dropout_rate)

    def forward(self, x, enc, self_attn_mask, enc_mask):
        """Teacher-forced decode.  x: embedded decoder inputs [B, L, d];
        self_attn_mask [B, L]; enc [B, S, d]; enc_mask [B, S].  Position q
        attends to the unmasked positions <= q."""
        l = x.shape[1]
        bias = self.rel_bias(l, l)
        cross_bias = self.cross_rel_bias(l, enc.shape[1])
        causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
        self_mask = causal[None, None] & self_attn_mask[:, None, None, :].bool()
        cross_mask = enc_mask[:, None, None, :].bool()
        x = _run_blocks(self.blocks, self.remat, self.drop(x), enc, self_mask,
                        cross_mask, bias, cross_bias)
        return self.drop(self.final_norm(x))

    def init_cache(self, batch: int, max_len: int, enc: torch.Tensor,
                   num_beams: int = 1) -> dict[str, torch.Tensor]:
        """Per-layer time-major self K/V buffers (batch·num_beams rows),
        cross K/V projected once per query from the un-expanded encoder
        output, and at routed layers each row's tokens per expert so far
        (``moe_count_<i>`` [rows, E] int32, zero)."""
        cache = {}
        inner = self.num_heads * self.d_kv
        dtype = self.final_norm.scale.dtype
        # the bias ids of every position the cache serves, on the device
        # before a decode step is captured in a CUDA graph
        for pos in range(max_len):
            self.rel_bias.bucket_ids(1, max_len, pos, enc.device)
            self.cross_rel_bias.bucket_ids(1, enc.shape[1], pos, enc.device)
        for i, blk in enumerate(self.blocks):
            ck, cv = blk.cross_attn.precompute_kv(enc)
            cache[f"tm_self_k_{i}"] = torch.zeros(
                (max_len, batch * num_beams, inner), dtype=dtype,
                device=enc.device)
            cache[f"tm_self_v_{i}"] = torch.zeros_like(cache[f"tm_self_k_{i}"])
            cache[f"cross_k_{i}"] = ck
            cache[f"cross_v_{i}"] = cv
            if blk.routed:
                cache[f"moe_count_{i}"] = torch.zeros(
                    (batch * num_beams, blk.ff.router.shape[0]),
                    dtype=torch.int32, device=enc.device)
        return cache

    def decode_step(self, x_t: torch.Tensor, cache: dict, enc_mask: torch.Tensor,
                    pos: int, num_beams: int = 1):
        """One decode step.  x_t: [B·K, 1, d] embedded token at ``pos``;
        enc_mask: [B, S] per query.  Returns (final-normed hidden [B·K, 1, d],
        cache) — the self caches are written at ``pos`` in place."""
        lmax = cache["tm_self_k_0"].shape[0]
        b, s = enc_mask.shape
        bias_row = self.rel_bias(1, lmax, q_offset=pos)           # [1,H,1,L]
        bias_self = bias_row[0, :, 0].t().float().contiguous()    # [L, H]
        cross_row = self.cross_rel_bias(1, s, q_offset=pos)       # [1,H,1,S]
        pad = torch.where(enc_mask[:, None, :].bool(), 0.0, NEG_INF)
        cross_bias = (cross_row[0, :, 0][None].float().expand(b, -1, -1)
                      + pad).contiguous()                          # [B, H, S]
        cache = dict(cache)
        x = x_t[:, 0]
        for i, blk in enumerate(self.blocks):
            x, sk, sv = blk.decode_step(
                x, cache[f"tm_self_k_{i}"], cache[f"tm_self_v_{i}"],
                cache[f"cross_k_{i}"], cache[f"cross_v_{i}"], pos, bias_self,
                cross_bias, num_beams, cache.get(f"moe_count_{i}"))
            cache[f"tm_self_k_{i}"] = sk
            cache[f"tm_self_v_{i}"] = sv
        return self.final_norm(x[:, None]), cache


@torch.no_grad()
def init_t5_weights(model: nn.Module, generator: torch.Generator
                    ) -> nn.Module:
    """Seeded random weights of a T5 text model (``models/seq2seq.py``,
    ``models/classifier.py``) at the reference's initialiser scales: the
    shared table N(0, 1), projections and rel-bias tables N(0, 0.02), the
    classifier head ``fc`` N(0, 1/fan_in) with bias 0, norm scales 1.  Not
    the reference's draws (``convert.py`` bridges those)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            std = (1.0 if name == "shared.weight"
                   else p.shape[1] ** -0.5 if name == "fc.weight" else 0.02)
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * std)
    return model
