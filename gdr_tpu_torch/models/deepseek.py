"""A decoder-only DeepSeek-V3 stack (as Moonlight-16B-A3B publishes it) as
GDR's generator, mirroring ``transformers``' ``DeepseekV3Model`` equation
for equation, in the model dtype (f32 on the card).

Each layer is pre-norm: x += MLA(RMSNorm(x)); x += FFN(RMSNorm(x)).

- **MLA** (latent attention, no q LoRA): q = W_q h → per head [nope | rope];
  [c | k_pe] = W_kva h; [k_nope | v] = W_kvb RMSNorm(c) per head (that
  norm's eps is ``transformers``' default 1e-6); RoPE on q_pe and the
  one k_pe of all heads, with ``transformers``' de-interleaved rope
  dimensions; softmax((q·k)·(nope + rope)^-0.5) · v; x += W_o ctx.
- **FFN**: the first ``first_k_dense`` layers a SwiGLU W_o(silu(W_g h) ⊙
  W_u h) of width ``d_ff``; the others :class:`MoE`: the shared experts (one
  SwiGLU of width ``moe_d_ff · num_shared_experts``) plus the top-k routed
  SwiGLU experts (``kernels/experts.py::topk_expert_sublayer``), of which
  the model may hold a chip's share (``ModelConfig.experts_held``).

A layer's attention module runs its own part of the prefill, the decode
caches and a decode step (:meth:`MLAttention.prefill`, ``init_cache``,
``decode``), so that a stack whose layers differ in kind
(``models/kimi_linear.py``) shares the loop.

GDR's glue.  The query's real tokens run through the stack causally at
positions 0 … n−1 (:meth:`DeepseekStack.prefill`; pads are masked and
never attended); CID step t feeds its decode token at position n + t and
attends to the query's prefix keys and values, shared by all the query's
beams and never reordered (``cross_mla_*`` cache entries), and to its own
earlier steps' (``tm_mla_*``, reordered with the beams), under one softmax
(``kernels/mla.py``).  The final norm's output feeds GDR's CID and PAWA
heads (``models/gdr.py``); the dense-stage query is the final-normed state
of the last real query token.

Every projection runs through ``kernels/decode.py::gemm`` (RMSNorm fused
in front, or the residual behind): the f32 GEMM kernels on the card, the
plain product on the CPU.  The prefill's attention core is plain PyTorch.
Training is refused (``ModelConfig.refuse_experts``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gdr_tpu_torch.kernels.decode import gemm
from gdr_tpu_torch.kernels.experts import topk_expert_sublayer
from gdr_tpu_torch.kernels.mla import (NEG_INF, mla_attention, rope,
                                       rope_inv_freq)
from gdr_tpu_torch.models.t5 import RMSNorm
from gdr_tpu_torch.utils.timing import span

KV_NORM_EPS = 1e-6      # transformers' DeepseekV3RMSNorm default


class MLAttention(nn.Module):
    """Latent attention's weights in ``nn.Linear`` layout [out, in]."""

    def __init__(self, d: int, heads: int, rank: int, nope: int, rp: int,
                 vdim: int, rotate: bool = True):
        super().__init__()
        self.heads, self.rank, self.nope, self.rp, self.vdim = \
            heads, rank, nope, rp, vdim
        self.rotate = rotate          # False: NoPE (q_pe, k_pe unrotated)
        self.q_proj = nn.Linear(d, heads * (nope + rp), bias=False)
        self.kv_a = nn.Linear(d, rank + rp, bias=False)
        self.kv_norm = RMSNorm(rank, KV_NORM_EPS)
        self.kv_b = nn.Linear(rank, heads * (nope + vdim), bias=False)
        self.o = nn.Linear(heads * vdim, d, bias=False)

    @property
    def scale(self) -> float:
        return (self.nope + self.rp) ** -0.5

    def project(self, x, ln: RMSNorm):
        """The raw projections of rows x [R, d] under the block's norm
        ``ln``: q [R, H·(nope+rope)], kva [R, rank+rope], kvb [R,
        H·(nope+v)]."""
        q = gemm(x, self.q_proj.weight, "round", scale=ln.scale, eps=ln.eps)
        kva = gemm(x, self.kv_a.weight, "round", scale=ln.scale, eps=ln.eps)
        kvb = gemm(kva[:, :self.rank].contiguous(), self.kv_b.weight, "round",
                   scale=self.kv_norm.scale, eps=self.kv_norm.eps)
        return q, kva, kvb

    def prefill(self, i: int, ln: RMSNorm, xs, geo: dict, inv_freq,
                cache: dict):
        """xs [B·S, d] + this layer's attention over the query, causal;
        its keys and values to ``cache`` (``cross_mla_k_<i>`` [B, H, S,
        nope+rope], ``cross_mla_v_<i>`` [B, H, S, v])."""
        b, s, pos = geo["batch"], geo["seq"], geo["pos"]
        h, nope, rp = self.heads, self.nope, self.rp
        q, kva, kvb = self.project(xs, ln)
        q = q.view(b, s, h, nope + rp)
        k_pe = kva[:, self.rank:].view(b, s, rp)
        if self.rotate:
            q = torch.cat([q[..., :nope],
                           rope(q[..., nope:], pos[None, :, None], inv_freq)],
                          dim=-1)
            k_pe = rope(k_pe, pos[None], inv_freq)
        kv = kvb.view(b, s, h, nope + self.vdim)
        k = torch.cat([kv[..., :nope],
                       k_pe[:, :, None].expand(b, s, h, rp)], dim=-1)
        k = k.transpose(1, 2).contiguous()                    # [B,H,S,dk]
        v = kv[..., nope:].transpose(1, 2).contiguous()       # [B,H,S,v]
        scores = (q.transpose(1, 2).float() @ k.float().transpose(-1, -2)
                  ) * self.scale
        scores = torch.where(geo["allow"], scores,
                             torch.full_like(scores, NEG_INF))
        ctx = (torch.softmax(scores, dim=-1) @ v.float()).to(xs.dtype)
        ctx = ctx.transpose(1, 2).reshape(b * s, h * self.vdim).contiguous()
        cache[f"cross_mla_k_{i}"] = k
        cache[f"cross_mla_v_{i}"] = v
        return gemm(ctx, self.o.weight, "residual", resid=xs)

    def init_cache(self, i: int, cache: dict, max_len: int, rows: int):
        """Each beam row's key and value buffers ``tm_mla_k_<i>`` [L,
        rows, H, nope+rope] and ``tm_mla_v_<i>`` [L, rows, H, v] (zero)."""
        k, v = cache[f"cross_mla_k_{i}"], cache[f"cross_mla_v_{i}"]
        cache[f"tm_mla_k_{i}"] = k.new_zeros((max_len, rows, self.heads,
                                              k.shape[-1]))
        cache[f"tm_mla_v_{i}"] = v.new_zeros((max_len, rows, self.heads,
                                              v.shape[-1]))

    def decode(self, i: int, ln: RMSNorm, x, cache: dict, pos: int,
               num_beams: int, inv_freq):
        """x [B·W, d] + this layer's attention of the step at ``pos``
        (``kernels/mla.py``), its key and value written in place."""
        q, kva, kvb = self.project(x, ln)
        ctx = mla_attention(
            q, kva, kvb, cache[f"cross_mla_k_{i}"],
            cache[f"cross_mla_v_{i}"], cache["cross_mla_bias"],
            cache["cross_mla_len"], cache[f"tm_mla_k_{i}"],
            cache[f"tm_mla_v_{i}"], pos, inv_freq, num_beams,
            scale=self.scale, rotate=self.rotate)
        return gemm(ctx, self.o.weight, "residual", resid=x)


class SwiGLU(nn.Module):
    """The dense FFN: ``wi`` [2·d_ff, d] (gate rows, then up rows), ``wo``
    [d, d_ff]."""

    def __init__(self, d: int, dff: int):
        super().__init__()
        self.wi = nn.Linear(d, 2 * dff, bias=False)
        self.wo = nn.Linear(dff, d, bias=False)

    def residual(self, x, ln: RMSNorm):
        return swiglu(x, ln, self.wi.weight, self.wo.weight)


def swiglu(x, ln: RMSNorm, wi, wo):
    """x + W_o(silu(W_g h) ⊙ W_u h), h = ln(x), rows x [R, d]."""
    gu = gemm(x, wi, "round", scale=ln.scale, eps=ln.eps)
    f = wi.shape[0] // 2
    hid = (F.silu(gu[:, :f]) * gu[:, f:]).contiguous()
    return gemm(hid, wo, "residual", resid=x)


class MoE(nn.Module):
    """Routed experts with shared experts: ``router`` [E, d], ``score_bias``
    [E] (selection only), ``wi`` [held, 2·d_ff, d], ``wo`` [held, d, d_ff]
    (experts ``offset`` … ``offset + held − 1``; all E by default),
    ``shared_wi`` [2·d_s, d], ``shared_wo`` [d, d_s].  ``record``: a list
    that each call appends its chosen experts [R, k] int32 and router
    logits [R, E] f32 to (None: nothing recorded), for a comparison that
    follows the program's routing."""

    def __init__(self, d: int, dff: int, n_exp: int, k: int, n_shared: int,
                 scale: float, held: int = 0, offset: int = 0):
        super().__init__()
        self.k, self.route_scale, self.offset = k, scale, offset
        held = held or n_exp
        self.router = nn.Parameter(torch.zeros(n_exp, d))
        self.score_bias = nn.Parameter(torch.zeros(n_exp))
        self.wi = nn.Parameter(torch.zeros(held, 2 * dff, d))
        self.wo = nn.Parameter(torch.zeros(held, d, dff))
        self.shared_wi = nn.Parameter(torch.zeros(2 * dff * n_shared, d))
        self.shared_wo = nn.Parameter(torch.zeros(d, dff * n_shared))
        self.record: list | None = None

    def residual(self, x, ln: RMSNorm):
        if self.training:
            raise NotImplementedError(
                "sparse experts serve only: the router's balancing of "
                "training is not ported")
        r = x.shape[0]
        with span("gdr.moe", f"rows={r} k={self.k}"):
            base = swiglu(x, ln, self.shared_wi, self.shared_wo)
            route = logits = None
            if self.record is not None:
                route = torch.empty((r, self.k), dtype=torch.int32,
                                    device=x.device)
                logits = torch.empty((r, self.router.shape[0]),
                                     dtype=torch.float32, device=x.device)
                self.record.append((route, logits))
            return topk_expert_sublayer(
                x, base, ln.scale, self.router, self.score_bias, self.wi,
                self.wo, k=self.k, scale=self.route_scale, eps=ln.eps,
                route=route, logits=logits, offset=self.offset)


class Block(nn.Module):
    """A pre-norm layer: ``attn`` (latent attention unless given) and a
    dense or routed FFN."""

    def __init__(self, c, dense: bool, attn: nn.Module | None = None):
        super().__init__()
        self.ln1 = RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.attn = attn if attn is not None else MLAttention(
            c.d_model, c.num_heads, c.kv_lora_rank, c.qk_nope_head_dim,
            c.qk_rope_head_dim, c.v_head_dim, not c.mla_use_nope)
        self.ln2 = RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.ff = (SwiGLU(c.d_model, c.d_ff) if dense else
                   MoE(c.d_model, c.moe_d_ff, c.num_experts,
                       c.num_experts_per_tok, c.num_shared_experts,
                       c.routed_scaling_factor, c.n_held, c.expert_offset))


class DeepseekStack(nn.Module):
    """The layers and the final norm; :meth:`prefill` over the query and
    :meth:`decode_step` over the CID steps."""

    def __init__(self, c):
        super().__init__()
        self.blocks = nn.ModuleList([
            Block(c, i < c.first_k_dense, self.attention(c, i))
            for i in range(c.num_layers)])
        self.final_norm = RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.register_buffer("inv_freq", rope_inv_freq(c.qk_rope_head_dim,
                                                       c.rope_theta),
                             persistent=False)

    @staticmethod
    def attention(c, i: int) -> nn.Module | None:
        """Layer ``i``'s attention module; None: :class:`MLAttention`."""
        return None

    def prefill(self, x: torch.Tensor, mask: torch.Tensor):
        """x: the query's embedded tokens [B, S, d]; mask [B, S] (1 = token,
        pads after the tokens).  Returns (final-normed states [B, S, d],
        the prefix caches: each layer's (:meth:`MLAttention.prefill`), and
        ``cross_mla_bias`` [B, S] f32 (−1e9 at pads), ``cross_mla_len``
        [B] int32)."""
        b, s, d = x.shape
        keep = mask.bool()
        lens = keep.sum(1).to(torch.int32)
        bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
        pos = torch.arange(s, device=x.device)
        causal = pos[None, :] <= pos[:, None]                     # [S, S]
        geo = dict(batch=b, seq=s, pos=pos, lens=lens,
                   allow=causal[None, None] & keep[:, None, None, :])
        cache = {"cross_mla_bias": bias, "cross_mla_len": lens}
        xs = x.reshape(b * s, d)
        for i, blk in enumerate(self.blocks):
            xs = blk.attn.prefill(i, blk.ln1, xs, geo, self.inv_freq, cache)
            xs = blk.ff.residual(xs, blk.ln2)
        return self.final_norm(xs).view(b, s, d), cache

    def init_cache(self, prefix: dict, max_len: int, num_beams: int
                   ) -> dict[str, torch.Tensor]:
        """The prefix caches and each layer's beam-row caches
        (:meth:`MLAttention.init_cache`)."""
        cache = dict(prefix)
        rows = prefix["cross_mla_len"].shape[0] * num_beams
        for i, blk in enumerate(self.blocks):
            blk.attn.init_cache(i, cache, max_len, rows)
        return cache

    def decode_step(self, x: torch.Tensor, cache: dict, pos: int,
                    num_beams: int):
        """One CID step of rows x [B·W, d] (the step's embedded tokens) at
        position n + ``pos``.  Returns (final-normed states [B·W, d], the
        cache with this step's keys and values written in place)."""
        cache = dict(cache)
        for i, blk in enumerate(self.blocks):
            x = blk.attn.decode(i, blk.ln1, x, cache, pos, num_beams,
                                self.inv_freq)
            x = blk.ff.residual(x, blk.ln2)
        return self.final_norm(x), cache
