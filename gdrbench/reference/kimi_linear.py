"""The GDR generator with Kimi Linear's hybrid stack (Kimi-Linear-48B-A3B:
Moonshot AI 2025, arXiv:2510.26692) in plain PyTorch and float32, layer by
layer, each beam's whole query + CID sequence recomputed at every step:

    h = RMSNorm(x)
    KDA layers (the ``fla`` library's KimiDeltaAttention):
        q, k, v = SiLU(causal depthwise conv_T(W_{q,k,v} h)), H heads of K
        q = q / sqrt(Σq² + 1e-6) · K^-½;  k = k / sqrt(Σk² + 1e-6)
        g = −exp(A_log[head]) · softplus(W_fb W_fa h + dt_bias)
        β = sigmoid(W_b h)[head]
        token by token from S = 0:
            S ← diag(exp g) S;  S ← S + β k (vᵀ − kᵀS);  o = Sᵀq
        x += W_o (RMSNorm_head(o) ⊙ sigmoid(W_gb W_ga h))
    MLA layers, NoPE (``mla_use_nope``): as ``moonlight.py``'s, with q_pe
        and k_pe unrotated
    h = RMSNorm(x)
    layer 0: x += dense SwiGLU(h)
    others:  x += Σ_{chosen j held here} w_j E_j(h) + shared(h), the k
             experts and their weights chosen over all E (sigmoid scores,
             a selection-only bias, renormalised, × routed_scaling_factor)

**The chip's share.**  The weights hold only experts ``expert_offset`` …
``expert_offset + experts_held − 1`` of the E that the router scores, as
the card of an expert-parallel deployment holds them; what the others add
is left out here as in the program.  The routed sum and the route
following are ``moonlight.py``'s (:func:`moonlight.routed`), over an
expert table whose absent experts are empty matrices: their product is an
exact zero of the row's width, so they add nothing and cost nothing.

There is no cache and no state carried from step to step; ``serve.py``
searches and re-ranks through ``moonlight.py``'s ``retrieve``, given this
stack.  Nothing here imports the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gdrbench.reference import model as M
from gdrbench.reference import moonlight as ref_ds
from gdrbench.reference.moonlight import (ROUTE_TIE_GAP, Beams,  # noqa: F401
                                          Routing)

L2_EPS = 1e-6


class _Held:
    """Experts ``offset`` … ``offset + len(t) − 1`` of an expert table
    [E, a, b] (``t`` holds them): an absent expert is an empty matrix, [0,
    b] (``rows``) or [a, 0]."""

    def __init__(self, t: torch.Tensor, offset: int, rows: bool):
        self.t, self.offset = t, offset
        shape = (0, t.shape[2]) if rows else (t.shape[1], 0)
        self.empty = t.new_zeros(shape, dtype=torch.float32)

    def float(self):
        return self

    def __getitem__(self, e: int) -> torch.Tensor:
        j = e - self.offset
        return M.ROUND(self.t[j].float()) if 0 <= j < len(self.t) \
            else self.empty


def _share(w: dict, p: str, cfg: dict) -> dict:
    """``w`` with layer ``p``'s expert tables as :class:`_Held`."""
    off = cfg.get("expert_offset", 0)
    return {**w, p + "ff.wi": _Held(w[p + "ff.wi"], off, rows=True),
            p + "ff.wo": _Held(w[p + "ff.wo"], off, rows=False)}


def kda(w: dict, p: str, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    """The KDA layer's output (before the residual) over h [N, L, d],
    causal from position 0."""
    n, l, _ = h.shape
    heads, dk, taps = (cfg["kda_num_heads"], cfg["kda_head_dim"],
                       cfg["kda_conv_size"])
    a = p + "attn."
    x = M.mm(h, M.w32(w, a + "qkv.weight").t())               # [N, L, 3HK]
    pad = torch.cat([x.new_zeros((n, taps - 1, x.shape[-1])), x], dim=1)
    cw = M.w32(w, a + "conv")                                  # [3HK, T]
    y = sum(pad[:, j:j + l] * cw[:, j] for j in range(taps))
    q, k, v = (t.reshape(n, l, heads, dk) for t in F.silu(y).chunk(3, -1))
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + L2_EPS) * dk ** -0.5
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + L2_EPS)
    fgb = M.mm(h, M.w32(w, a + "fgb.weight").t())
    f = M.mm(fgb[..., :dk], M.w32(w, a + "f_b.weight").t())
    og = M.mm(fgb[..., dk:2 * dk], M.w32(w, a + "g_b.weight").t())
    g = -torch.exp(M.w32(w, a + "A_log"))[:, None] * F.softplus(
        (f + M.w32(w, a + "dt_bias")).view(n, l, heads, dk))
    beta = torch.sigmoid(fgb[..., 2 * dk:])                   # [N, L, H]
    s = h.new_zeros((n, heads, dk, dk))
    o = h.new_zeros((n, l, heads, dk))
    for t in range(l):
        s = s * torch.exp(g[:, t])[..., None]
        u = torch.einsum("nhk,nhkv->nhv", k[:, t], s)
        s = s + (beta[:, t, :, None] * k[:, t])[..., None] \
            * (v[:, t] - u)[:, :, None, :]
        o[:, t] = torch.einsum("nhk,nhkv->nhv", q[:, t], s)
    o = o * torch.rsqrt((o * o).mean(-1, keepdim=True)
                        + cfg["layer_norm_epsilon"])
    o = M.ROUND(o * M.w32(w, a + "o_norm.scale")
                * torch.sigmoid(og.view(n, l, heads, dk)))
    return M.mm(o.reshape(n, l, heads * dk), M.w32(w, a + "o.weight").t())


def attention_nope(w: dict, p: str, cfg: dict, h: torch.Tensor
                   ) -> torch.Tensor:
    """MLA over h [N, L, d], causal, q_pe and k_pe unrotated."""
    n, l, _ = h.shape
    heads = cfg["num_heads"]
    nope, rp = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = M.mm(h, M.w32(w, p + "attn.q_proj.weight").t()).view(
        n, l, heads, nope + rp).transpose(1, 2)
    kva = M.mm(h, M.w32(w, p + "attn.kv_a.weight").t())
    c = M.rms_norm(kva[..., :rank], M.w32(w, p + "attn.kv_norm.scale"),
                   ref_ds.KV_NORM_EPS)
    kv = M.mm(c, M.w32(w, p + "attn.kv_b.weight").t()).view(
        n, l, heads, nope + vd).transpose(1, 2)
    k_pe = kva[..., rank:][:, None]
    k = torch.cat([kv[..., :nope], k_pe.expand(n, heads, l, rp)], dim=-1)
    s = M.mm(q, k.transpose(-1, -2), held=False) * (nope + rp) ** -0.5
    causal = torch.ones((l, l), dtype=torch.bool, device=h.device).tril()
    s = torch.where(causal, s, torch.full_like(s, M.NEG))
    ctx = M.mm(M.ROUND(torch.softmax(s, dim=-1)), kv[..., nope:])
    ctx = ctx.transpose(1, 2).reshape(n, l, heads * vd)
    return M.mm(ctx, M.w32(w, p + "attn.o.weight").t())


def stack(w: dict, cfg: dict, x: torch.Tensor, keys=None, follow=None,
          routing: Routing | None = None, scores: list | None = None
          ) -> torch.Tensor:
    """Final-normed states [N, L, d] of embedded sequences x [N, L, d]
    (no pads), causal from position 0; ``keys``, ``follow``, ``routing``
    and ``scores`` as ``moonlight.stack`` takes them."""
    eps = cfg["layer_norm_epsilon"]
    routing = Routing() if routing is None else routing
    for i in range(cfg["num_layers"]):
        p = f"stack.blocks.{i}."
        h = M.rms_norm(x, M.w32(w, p + "ln1.scale"), eps)
        mix = kda if i + 1 in cfg["kda_layers"] else attention_nope
        x = M.ROUND(x + mix(w, p, cfg, h))
        h = M.rms_norm(x, M.w32(w, p + "ln2.scale"), eps)
        if i < cfg["first_k_dense"]:
            f = ref_ds.swiglu(h, M.w32(w, p + "ff.wi.weight"),
                              M.w32(w, p + "ff.wo.weight"))
        else:
            f = M.ROUND(ref_ds.routed(_share(w, p, cfg), p, cfg, h, i, keys,
                                      follow, routing, scores)
                        + ref_ds.swiglu(h, M.w32(w, p + "ff.shared_wi"),
                                        M.w32(w, p + "ff.shared_wo")))
        x = M.ROUND(x + f)
    return M.rms_norm(x, M.w32(w, "stack.final_norm.scale"), eps)


def encode(w, cfg, ids, mask, follow=None, routing=None):
    """The query's final-normed states [B, S, d] (``moonlight.encode``
    over this stack)."""
    with _this_stack():
        return ref_ds.encode(w, cfg, ids, mask, follow, routing)


def retrieve(w: dict, cfg: dict, ecfg: dict, store: torch.Tensor, trie,
             cid_to_docs: dict, ids, mask, max_len: int, follow=None,
             log: dict | None = None):
    """``moonlight.retrieve`` over this stack: one batch's beams (with the
    routing counts) and re-rank."""
    with _this_stack():
        return ref_ds.retrieve(w, cfg, ecfg, store, trie, cid_to_docs, ids,
                               mask, max_len, follow, log)


class _this_stack:
    """``moonlight.py``'s sequence functions run this module's
    :func:`stack` while it is entered."""

    def __enter__(self):
        self.plain, ref_ds.stack = ref_ds.stack, stack

    def __exit__(self, *exc):
        ref_ds.stack = self.plain
