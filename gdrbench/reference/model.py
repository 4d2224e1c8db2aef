"""The GDR generator in plain PyTorch and float32: the T5 encoder, the CID
decoder with its relative position biases, and the efficient PAWA head,
as published (T5: Raffel et al. 2020, relative buckets of mesh-tensorflow
T5; GDR: Yuan et al. 2024, the reference's ``modeling_t5.py``).

Every function takes the weight dict of ``gdrbench/weights.py`` (the
same names the port gives its parameters) and computes in float32 with
TF32 off, whatever the weights' dtype.  Nothing here imports the port.

``drop`` is the dropout hook of training: it receives each tensor at
every place the generator applies dropout, in the order the forward pass
reaches them, and returns it (the identity when serving).
"""

from __future__ import annotations

import math

import torch

NEG = -1e9


def _identity(x):
    return x


# the rounding of every value a lower-precision program would hold in its
# compute dtype (weights, products, norms, residual sums, attention
# probabilities): none in the configuration's float32;
# ``reference/train.py::computed_in`` sets it for the control
ROUND = _identity


def mm(a: torch.Tensor, b: torch.Tensor, held: bool = True) -> torch.Tensor:
    """a @ b; ``held``: its result is held in the compute dtype (scores
    and logits are kept in float32)."""
    out = ROUND(a) @ ROUND(b)
    return ROUND(out) if held else out


def f32_matmul_only() -> None:
    """Products in true float32 (the configuration's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def w32(w: dict, name: str) -> torch.Tensor:
    return ROUND(w[name].float())


def rms_norm(x, scale, eps=1e-6):
    return ROUND(x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
                 * scale)


def layer_norm(x, weight, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ROUND((x - mu) * torch.rsqrt(var + eps) * weight + bias)


def rel_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
               max_distance: int) -> torch.Tensor:
    """T5's log-bucketing of relative positions (memory − query), in
    float32 as the published implementation computes it."""
    n = -rel.to(torch.int64)
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    f = torch.float32
    large = torch.log(n.to(f) / torch.tensor(max_exact, dtype=f)
                      + torch.tensor(1e-6, dtype=f))
    large = large / torch.log(torch.tensor(max_distance / max_exact, dtype=f))
    large = large * torch.tensor(num_buckets - max_exact, dtype=f)
    large = (max_exact + large.to(torch.int32).long()).clamp_max(
        num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def position_bias(table: torch.Tensor, qlen: int, klen: int,
                  bidirectional: bool, max_distance: int) -> torch.Tensor:
    """[H, qlen, klen] bias of a [buckets, H] table."""
    q = torch.arange(qlen)[:, None]
    k = torch.arange(klen)[None, :]
    b = rel_bucket(k - q, bidirectional, table.shape[0], max_distance)
    return table.float()[b.to(table.device)].permute(2, 0, 1)


def attention(x, kv, wqkv, wo, heads: int, bias=None, mask=None,
              drop=_identity):
    """T5-style attention (no 1/sqrt(d) scale): x [B, Lq, d] attends to
    kv [B, Lk, d]; ``mask`` broadcastable to [B, H, Lq, Lk] (True keeps),
    ``bias`` to the scores.  Returns [B, Lq, d]."""
    n = wqkv.shape[0] // 3
    b, lq, _ = x.shape
    lk = kv.shape[1]
    dk = n // heads
    q = mm(x, wqkv[:n].t()).view(b, lq, heads, dk).transpose(1, 2)
    k = mm(kv, wqkv[n:2 * n].t()).view(b, lk, heads, dk).transpose(1, 2)
    v = mm(kv, wqkv[2 * n:].t()).view(b, lk, heads, dk).transpose(1, 2)
    s = mm(q, k.transpose(-1, -2), held=False)
    if bias is not None:
        s = s + bias
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG))
    p = drop(ROUND(torch.softmax(s, dim=-1)))
    ctx = mm(p, v).transpose(1, 2).reshape(b, lq, n)
    return mm(ctx, wo.t())


def encode(w: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
           drop=_identity) -> torch.Tensor:
    """T5 encoder states [B, S, d] of token ids [B, S] under ``mask``."""
    eps, heads = cfg["layer_norm_epsilon"], cfg["num_heads"]
    x = drop(w32(w, "shared.weight")[ids.long()])
    s = ids.shape[1]
    bias = position_bias(w32(w, "encoder.rel_bias.rel_embedding"), s, s, True,
                         cfg["relative_attention_max_distance"])[None]
    m = mask.bool()[:, None, None, :]
    for i in range(cfg["num_layers"]):
        p = f"encoder.blocks.{i}."
        h = rms_norm(x, w32(w, p + "ln1.scale"), eps)
        h = attention(h, h, w32(w, p + "attn.qkv.weight"),
                      w32(w, p + "attn.o.weight"), heads, bias, m, drop)
        x = ROUND(x + drop(h))
        h = rms_norm(x, w32(w, p + "ln2.scale"), eps)
        h = drop(torch.relu(mm(h, w32(w, p + "ff.wi.weight").t())))
        x = ROUND(x + drop(mm(h, w32(w, p + "ff.wo.weight").t())))
    return drop(rms_norm(x, w32(w, "encoder.final_norm.scale"), eps))


def query_embedding(w: dict, cfg: dict, enc: torch.Tensor) -> torch.Tensor:
    q = enc[:, 0]
    if cfg["encoder_d_model"] != cfg["d_model"]:
        q = mm(q, w32(w, "query_proj.weight").t())
    return q


def decode(w: dict, cfg: dict, tokens: torch.Tensor, enc: torch.Tensor,
           enc_mask: torch.Tensor, self_mask=None, drop=_identity
           ) -> torch.Tensor:
    """Decoder states [B·W, L, d] (after the final norm) of decoder input
    tokens [B·W, L], W rows (beams) a query, over the queries' encoder
    states [B, S, d]: causal self-attention (and ``self_mask`` [B·W, L]
    where given), cross-attention under ``enc_mask`` [B, S]."""
    eps, heads = cfg["layer_norm_epsilon"], cfg["num_heads"]
    md = cfg["relative_attention_max_distance"]
    rows, l = tokens.shape
    nq = enc.shape[0]
    beams = rows // nq
    x = drop(w32(w, "decode_embed.weight")[tokens.long()])
    bias = position_bias(w32(w, "decoder.rel_bias.rel_embedding"), l, l, False,
                         md)[None]
    cross_bias = position_bias(w32(w, "decoder.cross_rel_bias.rel_embedding"),
                               l, enc.shape[1], True, md)[None]
    cross_bias = cross_bias.repeat(1, 1, beams, 1)     # row w·L + l
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    smask = causal[None, None]
    if self_mask is not None:
        smask = smask & self_mask.bool()[:, None, None, :]
    cmask = enc_mask.bool()[:, None, None, :]
    for i in range(cfg["num_decoder_layers"]):
        p = f"decoder.blocks.{i}."
        h = rms_norm(x, w32(w, p + "ln1.scale"), eps)
        x = ROUND(x + drop(attention(
            h, h, w32(w, p + "self_attn.qkv.weight"),
            w32(w, p + "self_attn.o.weight"), heads, bias, smask, drop)))
        h = rms_norm(x, w32(w, p + "ln2.scale"), eps)
        h = attention(h.reshape(nq, beams * l, -1), enc,
                      w32(w, p + "cross_attn.qkv.weight"),
                      w32(w, p + "cross_attn.o.weight"), heads, cross_bias,
                      cmask, drop)
        x = ROUND(x + drop(h.reshape(rows, l, -1)))
        h = rms_norm(x, w32(w, p + "ln3.scale"), eps)
        h = drop(torch.relu(mm(h, w32(w, p + "ff.wi.weight").t())))
        x = ROUND(x + drop(mm(h, w32(w, p + "ff.wo.weight").t())))
    return drop(rms_norm(x, w32(w, "decoder.final_norm.scale"), eps))


def pawa(w: dict, cfg: dict, tokens: torch.Tensor, drop=_identity
         ) -> torch.Tensor:
    """The PAWA adaptor's output A [B, L, d] over the decode embeddings of
    the prefix tokens [B, L]: post-norm layers of causal self-attention,
    attention to the one learned memory token and a ReLU feed-forward."""
    d = cfg["d_model"]
    heads = cfg["adaptor_num_heads"]
    x = w32(w, "decode_embed.weight")[tokens.long()]
    b, l, _ = x.shape
    mem = w32(w, "pawa.memory").expand(b, 1, d)
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["adaptor_layer_num"]):
        p = f"pawa.layers.{i}."
        h = attention(x, x, w32(w, p + "self_attn.qkv.weight"),
                      w32(w, p + "self_attn.o.weight"), heads,
                      mask=causal[None, None], drop=drop)
        x = layer_norm(x + drop(h), w32(w, p + "ln1.weight"),
                       w32(w, p + "ln1.bias"))
        h = attention(x, mem, w32(w, p + "cross_attn.qkv.weight"),
                      w32(w, p + "cross_attn.o.weight"), heads, drop=drop)
        x = layer_norm(x + drop(h), w32(w, p + "ln2.weight"),
                       w32(w, p + "ln2.bias"))
        h = mm(torch.relu(mm(x, w32(w, p + "ff1.weight").t())),
               w32(w, p + "ff2.weight").t())
        x = layer_norm(x + drop(h), w32(w, p + "ln3.weight"),
                       w32(w, p + "ln3.bias"))
    return x


def candidate_tokens(pos: int, kary: int) -> list[int]:
    """The token ids position ``pos`` may emit: its ``kary`` digits, then
    EOS (1)."""
    first = pos * kary + 2
    return list(range(first, first + kary)) + [1]


def candidate_logits(w: dict, cfg: dict, hidden: torch.Tensor,
                     adaptor: torch.Tensor, pos: int) -> torch.Tensor:
    """Logits [R, kary+1] of position ``pos``'s candidate tokens for
    decoder states and adaptor outputs [R, d] at that position: the tied
    head on hidden·d^-0.5 plus the PAWA delta Σ_ij A_j s_i U[j, v, i]."""
    kary = cfg["kary"]
    s = ROUND(hidden * cfg["d_model"] ** -0.5)
    toks = candidate_tokens(pos, kary)
    logits = mm(s, w32(w, "decode_embed.weight")[toks].t(), held=False)
    u = ROUND(w["pawa.u"].float())[:, toks, :]               # [d, V', d]
    d = u.shape[0]
    g = mm(adaptor, u.reshape(d, -1)).view(-1, len(toks), d)
    logits = logits + mm(g, s[..., None], held=False)[..., 0]
    if pos >= cfg["max_output_length"] - 1:
        logits[:, :kary] += NEG
    return logits


def sequence_candidate_logits(w: dict, cfg: dict, hidden: torch.Tensor,
                              adaptor: torch.Tensor) -> torch.Tensor:
    """Teacher-forced candidate logits [B, L, kary+1] at every position of
    decoder states and adaptor outputs [B, L, d]."""
    return torch.stack([candidate_logits(w, cfg, hidden[:, p], adaptor[:, p],
                                         p)
                        for p in range(hidden.shape[1])], dim=1)


def log_softmax_masked(logits: torch.Tensor, allowed: torch.Tensor
                       ) -> torch.Tensor:
    """log_softmax over all candidate slots, then NEG where not
    ``allowed`` (the trie's mask is applied after the normalisation)."""
    lp = torch.log_softmax(logits, dim=-1)
    return torch.where(allowed, lp, torch.full_like(lp, NEG))


def l2_norm(x: torch.Tensor) -> float:
    return math.sqrt(float((x.double() ** 2).sum()))
