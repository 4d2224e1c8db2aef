"""The GDR generator with a decoder-only DeepSeek-V3 backbone (Moonlight-
16B-A3B: DeepSeek-AI 2024, arXiv:2412.19437; Moonshot AI 2025,
arXiv:2502.16982) in plain PyTorch and float32, as ``transformers``'
``DeepseekV3Model`` computes it, layer by layer:

    h = RMSNorm(x)
    q = W_q h → per head [q_nope | q_pe];  [c | k_pe] = W_kva h
    [k_nope | v] = W_kvb RMSNorm_1e-6(c) per head
    q_pe, k_pe rotated (RoPE, de-interleaved rope dimensions, θ)
    x += W_o softmax((q·k) (nope + rope)^-0.5 + causal) v
    h = RMSNorm(x)
    dense layers:  x += W_d (silu(W_g h) ⊙ W_u h)
    expert layers: s = sigmoid(h·W_rᵀ); the k experts of the k largest
                   s + b; w_j = s_j / Σ s × routed_scaling_factor;
                   x += Σ_j w_j E_j(h) + shared(h)

GDR's glue: the query's real tokens at positions 0 … n−1, then each CID
step's decode token (``decode_embed``) at n + t; the final norm's states
feed GDR's CID head and PAWA head (``model.py``), and the dense-stage
query is the state of the last real query token through ``query_proj``.
The whole query + CID sequence of every beam is recomputed at every step
(no cache); ``serve.py`` searches and re-ranks.  Nothing here imports the
port: the weights are a dict of tensors under the port's names.

**Routing near ties.**  A sequence makes ~11,000 top-k decisions over its
layers, and an f32 program in another summation order may take the other
of two experts whose selection scores lie within rounding.  Where the
reference's own k-th and (k+1)-th selection scores lie within
:data:`ROUTE_TIE_GAP`, it takes the program's set (``follow``), after
checking that it differs from its own only among experts whose scores lie
within the gap of that boundary; a set that differs elsewhere is refused
(the reference keeps its own and counts it).  :class:`Routing` counts the
decisions, those followed, refused and those for which the program gave
no set.
"""

from __future__ import annotations

import types
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from gdrbench.reference import model as M
from gdrbench.reference import serve as S

# at least 10x the largest |program - reference| selection score (sigmoid
# + bias) that the card's test at the cell's widths sees; see the traffic
# file and PERF.md for the readings
ROUTE_TIE_GAP = 2e-4
KV_NORM_EPS = 1e-6
LOG_GAP = 10 * ROUTE_TIE_GAP


@dataclass
class Routing:
    """Counts of one retrieve's routing decisions (``decisions``) and of
    those whose scores lay within the gap (``near``): the program's set
    taken (``followed``), refused (``refused``), or not given
    (``unmatched``).  ``log``: a dict that takes (layer, key) → the chosen
    experts of every decision within :data:`LOG_GAP`, so that another
    reference can follow this one (the TF32 control)."""
    decisions: int = 0
    near: int = 0
    followed: int = 0
    refused: int = 0
    unmatched: int = 0
    min_gap: float = float("inf")
    log: dict | None = None

    def add(self, other: "Routing") -> None:
        for k in ("decisions", "near", "followed", "refused", "unmatched"):
            setattr(self, k, getattr(self, k) + getattr(other, k))
        self.min_gap = min(self.min_gap, other.min_gap)


@dataclass
class Beams(S.Beams):
    routing: Routing = field(default_factory=Routing)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [..., L, r] (interleaved pairs) rotated at ``positions`` [L]:
    pair i = (x[2i], x[2i+1]) → (a cos − b sin, b cos + a sin) at columns
    i and i + r/2 (``apply_rotary_pos_emb_interleave``)."""
    r = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, r, 2, device=x.device).float()
                           / r))
    f = positions.float()[:, None] * inv
    c, s = f.cos(), f.sin()
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def swiglu(h, wi, wo):
    f = wi.shape[0] // 2
    g = M.mm(h, wi.t())
    return M.mm(M.ROUND(F.silu(g[..., :f]) * g[..., f:]), wo.t())


def attention(w, p, cfg, h):
    """MLA over h [N, L, d], causal, positions 0 … L−1."""
    n, l, _ = h.shape
    heads = cfg["num_heads"]
    nope, rp = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    pos = torch.arange(l, device=h.device)
    q = M.mm(h, M.w32(w, p + "attn.q_proj.weight").t()).view(
        n, l, heads, nope + rp).transpose(1, 2)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos,
                                       cfg["rope_theta"])], dim=-1)
    kva = M.mm(h, M.w32(w, p + "attn.kv_a.weight").t())
    c = M.rms_norm(kva[..., :rank], M.w32(w, p + "attn.kv_norm.scale"),
                   KV_NORM_EPS)
    kv = M.mm(c, M.w32(w, p + "attn.kv_b.weight").t()).view(
        n, l, heads, nope + vd).transpose(1, 2)
    k_pe = rope(kva[..., rank:][:, None], pos, cfg["rope_theta"])
    k = torch.cat([kv[..., :nope], k_pe.expand(n, heads, l, rp)], dim=-1)
    s = M.mm(q, k.transpose(-1, -2), held=False) * (nope + rp) ** -0.5
    causal = torch.ones((l, l), dtype=torch.bool, device=h.device).tril()
    s = torch.where(causal, s, torch.full_like(s, M.NEG))
    ctx = M.mm(M.ROUND(torch.softmax(s, dim=-1)), kv[..., nope:])
    ctx = ctx.transpose(1, 2).reshape(n, l, heads * vd)
    return M.mm(ctx, M.w32(w, p + "attn.o.weight").t())


def routed(w, p, cfg, h, layer: int, keys, follow, routing: Routing,
           scores: list | None = None):
    """Σ_j w_j E_j(h) over h [N, L, d]; ``keys(n, l)`` names token (n, l)
    for ``follow(layer, key)``, which gives the program's set or None;
    ``scores`` takes the selection scores [N·L, E]."""
    k, gap = cfg["num_experts_per_tok"], ROUTE_TIE_GAP
    n, l, d = h.shape
    z = M.mm(h, M.w32(w, p + "ff.router").t(), held=False)
    s = torch.sigmoid(z).reshape(n * l, -1)
    choice = s + w[p + "ff.score_bias"].float()
    if scores is not None:
        scores.append(choice)
    srt = torch.sort(choice, dim=1, descending=True, stable=True)
    sel = srt.indices[:, :k].sort(dim=1).values
    margin = srt.values[:, k - 1] - srt.values[:, k]
    routing.decisions += n * l
    routing.min_gap = min(routing.min_gap, float(margin.min()))
    near = (margin < gap).nonzero()[:, 0].tolist()
    routing.near += len(near)
    if near:
        lo = (srt.values[near, k] - gap).cpu()
        hi = (srt.values[near, k - 1] + gap).cpu()
        ch = choice[near].cpu()
        own = sel[near].cpu()
        for i, t in enumerate(near):
            got = follow(layer, keys(t // l, t % l)) if follow else None
            if got is None:
                routing.unmatched += 1
                continue
            band = set(((ch[i] >= lo[i]) & (ch[i] <= hi[i])).nonzero()[:, 0]
                       .tolist())
            diff = set(got) ^ set(own[i].tolist())
            if len(set(got)) != k or not diff <= band:
                routing.refused += 1
                continue
            routing.followed += 1
            sel[t] = torch.as_tensor(sorted(got), device=sel.device)
    if routing.log is not None:
        logged = (margin < LOG_GAP).nonzero()[:, 0].tolist()
        for t, chosen in zip(logged, sel[logged].tolist()):
            routing.log[layer, keys(t // l, t % l)] = chosen
    wt = s.gather(1, sel)
    wt = wt / (wt.sum(1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    hf = h.reshape(n * l, d)
    y = torch.zeros((n * l, k, d), device=h.device)
    wi, wo = M.w32(w, p + "ff.wi"), M.w32(w, p + "ff.wo")
    for e in torch.unique(sel).tolist():
        rows, slot = (sel == e).nonzero(as_tuple=True)
        y[rows, slot] = swiglu(hf[rows], wi[e], wo[e])
    out = torch.zeros_like(hf)
    for j in range(k):
        out = out + wt[:, j:j + 1] * y[:, j]
    return M.ROUND(out.view(n, l, d))


def stack(w: dict, cfg: dict, x: torch.Tensor, keys=None, follow=None,
          routing: Routing | None = None, scores: list | None = None
          ) -> torch.Tensor:
    """Final-normed states [N, L, d] of embedded sequences x [N, L, d]
    (no pads), causal from position 0; ``scores`` takes each expert
    layer's selection scores [N·L, E]."""
    eps = cfg["layer_norm_epsilon"]
    routing = Routing() if routing is None else routing
    for i in range(cfg["num_layers"]):
        p = f"stack.blocks.{i}."
        h = M.rms_norm(x, M.w32(w, p + "ln1.scale"), eps)
        x = M.ROUND(x + attention(w, p, cfg, h))
        h = M.rms_norm(x, M.w32(w, p + "ln2.scale"), eps)
        if i < cfg["first_k_dense"]:
            f = swiglu(h, M.w32(w, p + "ff.wi.weight"),
                       M.w32(w, p + "ff.wo.weight"))
        else:
            f = M.ROUND(routed(w, p, cfg, h, i, keys, follow, routing,
                               scores)
                        + swiglu(h, M.w32(w, p + "ff.shared_wi"),
                                 M.w32(w, p + "ff.shared_wo")))
        x = M.ROUND(x + f)
    return M.rms_norm(x, M.w32(w, "stack.final_norm.scale"), eps)


def encode(w, cfg, ids, mask, follow=None, routing=None):
    """The query's final-normed states [B, S, d] (zero at pads), each
    query's real tokens alone."""
    out = torch.zeros(ids.shape + (cfg["d_model"],), device=ids.device)
    for b in range(ids.shape[0]):
        n = int(mask[b].sum())
        x = M.w32(w, "shared.weight")[ids[b, :n].long()][None]
        out[b, :n] = stack(w, cfg, x, lambda _, l: (b, ("p", l)), follow,
                           routing)[0]
    return out


def decode(w, cfg, tokens, ids, mask, follow=None, routing=None,
           block: int = 128):
    """States [B·W, L, d] of the CID inputs tokens [B·W, L] (W beams a
    query): each beam's query + CID sequence recomputed, in blocks of
    ``block`` beams, and the states of its CID positions returned."""
    rows, l = tokens.shape
    nq = ids.shape[0]
    beams = rows // nq
    out = torch.zeros((rows, l, cfg["d_model"]), device=tokens.device)
    for b in range(nq):
        n = int(mask[b].sum())
        q = M.w32(w, "shared.weight")[ids[b, :n].long()]
        for r0 in range(b * beams, (b + 1) * beams, block):
            r1 = min(r0 + block, (b + 1) * beams)
            tok = tokens[r0:r1]
            x = torch.cat([q[None].expand(r1 - r0, n, -1),
                           M.w32(w, "decode_embed.weight")[tok.long()]], 1)
            toks = tok.cpu().tolist()

            def keys(r, pos, toks=toks, n=n, b=b):
                if pos < n:
                    return b, ("p", pos)
                return b, tuple(toks[r][:pos - n + 1])
            out[r0:r1] = stack(w, cfg, x, keys, follow, routing)[:, n:]
    return out


def query_embedding(w, cfg, enc, mask):
    last = (mask.long().sum(1) - 1).clamp_min(0)
    q = enc[torch.arange(enc.shape[0], device=enc.device), last]
    return M.mm(q, M.w32(w, "query_proj.weight").t())


def retrieve(w: dict, cfg: dict, ecfg: dict, store: torch.Tensor,
             trie: S.Trie, cid_to_docs: dict, ids, mask, max_len: int,
             follow=None, log: dict | None = None
             ) -> tuple[Beams, S.Reranked]:
    """One batch's beams and re-rank as ``serve.retrieve`` gives them, the
    beams with the routing counts of the whole retrieve.  ``follow(layer,
    (query, key))``: the program's chosen experts of a token, key ("p", l)
    for the l-th query token and the tuple of CID inputs for a CID
    position, or None; ``log``: :class:`Routing`'s."""
    routing = Routing(log=log)
    ds = types.SimpleNamespace(**vars(M))
    ds.encode = lambda w_, c_, i_, m_: encode(w_, c_, i_, m_, follow,
                                              routing)
    ds.query_embedding = lambda w_, c_, e_: query_embedding(w_, c_, e_, mask)
    ds.decode = lambda w_, c_, t_, e_, m_: decode(w_, c_, t_, ids, mask,
                                                  follow, routing)
    plain, S.M = S.M, ds
    try:
        beams, rr = S.retrieve(w, cfg, ecfg, store, trie, cid_to_docs, ids,
                               mask, max_len)
    finally:
        S.M = plain
    return Beams(**vars(beams), routing=routing), rr
