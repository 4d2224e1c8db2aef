"""The GDR generator with a Switch Transformer backbone (Switch-Base: Fedus,
Zoph and Shazeer 2021) in plain PyTorch and float32: at the sparse layers
of the encoder and of the CID decoder the FFN is a top-1 routed mixture of
ReLU experts, as ``transformers``' ``SwitchTransformersSparseMLP`` with its
``Top1Router`` computes it:

    h = RMSNorm(x);  z = h·W_rᵀ (f32, no bias);  e = argmax softmax(z)
    π = softmax(z)[e];  x' = x + π · W_o[e] ReLU(W_i[e] h)

where a token adds 0 once ``expert_capacity`` earlier tokens of its
sequence went to e.  Everything else is ``model.py``'s, whose functions
are reused unchanged; the decoder is recomputed over each beam's whole
prefix and searched and re-ranked by ``serve.py``.  Nothing here imports
the port.

Besides the answer, :func:`retrieve` reports per query the smallest gap
between the two largest router logits of any routing decision made for
it (every encoder token, every decoder position of every beam at every
step), so that the comparison knows where rounding may send a token to
another expert.
"""

from __future__ import annotations

import types
from dataclasses import dataclass

import numpy as np
import torch

from gdrbench.reference import model as M
from gdrbench.reference import serve as S


@dataclass
class Beams(S.Beams):
    route_gap: np.ndarray | None = None   # [B] smallest top-two router gap


def sparse(i: int, step: int) -> bool:
    """Whether layer ``i`` of a stack with sparse step ``step`` routes its
    FFN (``transformers``' ``SwitchTransformersStack``)."""
    return step > 0 and (step == 1 or i % step == 1)


def routed_ffn(w: dict, p: str, cfg: dict, h: torch.Tensor,
               gaps: torch.Tensor | None) -> torch.Tensor:
    """π · expert(h) of the normed states h [N, L, d], N sequences of L
    tokens, under the leaves ``p + "router"`` / ``"wi"`` / ``"wo"``;
    ``gaps`` [Q] (N divided evenly over Q queries) takes each query's
    smallest top-two logit gap."""
    n, l, d = h.shape
    router = M.w32(w, p + "router")
    z = M.mm(h, router.t(), held=False)                  # [N, L, E]
    probs = torch.softmax(z, dim=-1)
    e = torch.argmax(probs, dim=-1)
    pi = probs.gather(-1, e[..., None])
    if gaps is not None:
        top = torch.topk(z, 2, dim=-1).values
        g = (top[..., 0] - top[..., 1]).double().reshape(len(gaps), -1)
        gaps.copy_(torch.minimum(gaps, g.min(1).values.cpu()))
    one = torch.nn.functional.one_hot(e, router.shape[0])
    prior = (one.cumsum(1) - one).gather(-1, e[..., None])[..., 0]
    keep = prior < cfg["expert_capacity"]
    y = torch.zeros_like(h)
    for j in torch.unique(e[keep]).tolist():
        at = keep & (e == j)
        hid = torch.relu(M.mm(h[at], M.w32(w, p + "wi")[j].t()))
        y[at] = M.mm(hid, M.w32(w, p + "wo")[j].t())
    return M.ROUND(pi * y)


def encode(w: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
           gaps: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder states [B, S, d]: ``model.encode`` with the routed FFN at
    the sparse layers (capacity counted over each query's S tokens, pads
    included, as ``transformers`` counts them)."""
    eps, heads = cfg["layer_norm_epsilon"], cfg["num_heads"]
    x = M.w32(w, "shared.weight")[ids.long()]
    s = ids.shape[1]
    bias = M.position_bias(M.w32(w, "encoder.rel_bias.rel_embedding"), s, s,
                           True, cfg["relative_attention_max_distance"])[None]
    m = mask.bool()[:, None, None, :]
    for i in range(cfg["num_layers"]):
        p = f"encoder.blocks.{i}."
        h = M.rms_norm(x, M.w32(w, p + "ln1.scale"), eps)
        x = M.ROUND(x + M.attention(h, h, M.w32(w, p + "attn.qkv.weight"),
                                    M.w32(w, p + "attn.o.weight"), heads,
                                    bias, m))
        h = M.rms_norm(x, M.w32(w, p + "ln2.scale"), eps)
        x = M.ROUND(x + _ffn(w, p, cfg, h,
                             sparse(i, cfg["encoder_sparse_step"]), gaps))
    return M.rms_norm(x, M.w32(w, "encoder.final_norm.scale"), eps)


def decode(w: dict, cfg: dict, tokens: torch.Tensor, enc: torch.Tensor,
           enc_mask: torch.Tensor, self_mask=None,
           gaps: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder states [B·W, L, d]: ``model.decode`` with the routed FFN at
    the sparse layers (capacity counted over each beam's L prefix
    tokens)."""
    eps, heads = cfg["layer_norm_epsilon"], cfg["num_heads"]
    md = cfg["relative_attention_max_distance"]
    rows, l = tokens.shape
    nq = enc.shape[0]
    beams = rows // nq
    x = M.w32(w, "decode_embed.weight")[tokens.long()]
    bias = M.position_bias(M.w32(w, "decoder.rel_bias.rel_embedding"), l, l,
                           False, md)[None]
    cross_bias = M.position_bias(
        M.w32(w, "decoder.cross_rel_bias.rel_embedding"), l, enc.shape[1],
        True, md)[None].repeat(1, 1, beams, 1)
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    smask = causal[None, None]
    if self_mask is not None:
        smask = smask & self_mask.bool()[:, None, None, :]
    cmask = enc_mask.bool()[:, None, None, :]
    for i in range(cfg["num_decoder_layers"]):
        p = f"decoder.blocks.{i}."
        h = M.rms_norm(x, M.w32(w, p + "ln1.scale"), eps)
        x = M.ROUND(x + M.attention(
            h, h, M.w32(w, p + "self_attn.qkv.weight"),
            M.w32(w, p + "self_attn.o.weight"), heads, bias, smask))
        h = M.rms_norm(x, M.w32(w, p + "ln2.scale"), eps)
        h = M.attention(h.reshape(nq, beams * l, -1), enc,
                        M.w32(w, p + "cross_attn.qkv.weight"),
                        M.w32(w, p + "cross_attn.o.weight"), heads,
                        cross_bias, cmask)
        x = M.ROUND(x + h.reshape(rows, l, -1))
        h = M.rms_norm(x, M.w32(w, p + "ln3.scale"), eps)
        x = M.ROUND(x + _ffn(w, p, cfg, h,
                             sparse(i, cfg["decoder_sparse_step"]), gaps))
    return M.rms_norm(x, M.w32(w, "decoder.final_norm.scale"), eps)


def _ffn(w, p, cfg, h, routed: bool, gaps):
    if routed:
        return routed_ffn(w, p + "ff.", cfg, h, gaps)
    h = torch.relu(M.mm(h, M.w32(w, p + "ff.wi.weight").t()))
    return M.mm(h, M.w32(w, p + "ff.wo.weight").t())


def retrieve(w: dict, cfg: dict, ecfg: dict, store: torch.Tensor,
             trie: S.Trie, cid_to_docs: dict, ids, mask, max_len: int
             ) -> tuple[Beams, S.Reranked]:
    """One batch's beams and re-rank as ``serve.retrieve`` gives them, the
    beams with each query's smallest top-two router logit gap
    (``route_gap``, float64)."""
    gaps = torch.full((ids.shape[0],), float("inf"), dtype=torch.float64)
    # serve.py's search and re-rank, over this module's encoder and decoder
    switch = types.SimpleNamespace(**vars(M))
    switch.encode = lambda *a: encode(*a, gaps=gaps)
    switch.decode = lambda *a: decode(*a, gaps=gaps)
    plain, S.M = S.M, switch
    try:
        beams, rr = S.retrieve(w, cfg, ecfg, store, trie, cid_to_docs, ids,
                               mask, max_len)
    finally:
        S.M = plain
    return Beams(**vars(beams), route_gap=gaps.numpy()), rr
