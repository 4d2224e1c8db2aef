"""Loss functions of the GDR objective, mirroring ``gdr_tpu/ops/losses.py``:
masked CE, the three R-Drop consistency variants, cluster-adaptive
InfoNCE, the hard-negative margin ranking loss, embedding and weight
distillation, and the denoising heads' losses.

Pure functions of tensors.  Every reduction runs in f32 whatever the input
dtype, where the reference package upcasts.  The only random draw, the
denoising replacement tokens, is ``argmax(logits + g)`` with Gumbel noise
``g`` handed in or drawn from a ``torch.Generator``: the form of
``jax.random.categorical``, so the reference's own noise gives the same
tokens.

**Over dp ranks.**  ``gdr_tpu`` computes each loss on the global batch and
XLA splits it.  Here a dp rank holds a slice of the batch, so each loss
takes ``dp`` (``parallel/autograd.py::DPShards``: the rank, the dp size, a
differentiable gather of every rank's rows and a differentiable SUM over
the ranks).  With ``dp`` a loss returns this rank's share of the global
batch's loss: its rows' terms over the **global** normaliser, and the
terms that couple rows (R-Drop Contrast, the query-token InfoNCE, the
cluster InfoNCE's inter-query terms) built from this rank's anchor rows
against keys gathered from every rank.  The shares sum over the ranks to
the global loss, and the backward of the gather sums each rank's gradient
at the rows it gathered, so the ranks' gradients sum to the global one.
A mean over a fixed shape divides by its global element count; a mean of
per-rank means would not equal it when the ranks' counts differ.
"""

from __future__ import annotations

from typing import Callable

import torch

from gdr_tpu_torch.ops.beam import gumbel_noise

Tensor = torch.Tensor


def _pick(logp: Tensor, labels: Tensor) -> Tensor:
    """logp[..., labels] over the last axis."""
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def _total(x: Tensor, dp) -> Tensor:
    """``x`` summed over the dp ranks (``x`` itself in one batch)."""
    return x if dp is None else dp.total(x)


def _count(n: int, like: Tensor, dp) -> Tensor:
    """The global count of a shape's ``n`` elements."""
    return _total(torch.tensor(float(n), device=like.device), dp)


def masked_cross_entropy(logits: Tensor, labels: Tensor,
                         label_mask: Tensor, dp=None) -> Tensor:
    """Token CE averaged over the valid positions.  logits [B, L, V];
    labels, label_mask [B, L]."""
    ll = _pick(torch.log_softmax(logits.float(), dim=-1), labels)
    mask = label_mask.float()
    return -(ll * mask).sum() / _total(mask.sum(), dp).clamp_min(1.0)


def rdrop_contrast_loss(decoder_hidden: Tensor, label_mask: Tensor,
                        dp=None) -> Tensor:
    """R-Drop "Contrast": the batch is two dropout realisations [x; x'];
    per position each row's decoder state must pick its twin among the
    other rows (in-batch InfoNCE between the halves, CE on the logits).
    decoder_hidden [2b, L, d] (already d**-0.5-scaled); label_mask
    [2b, L].  With ``dp`` this rank's [x_r; x'_r] are the anchors and the
    keys are the global twin layout [x_0 … x_{n−1}; x'_0 … x'_{n−1}], as
    the reference concatenates its global batch."""
    bz = decoder_hidden.shape[0]
    b = bz // 2
    h = decoder_hidden.float()
    rows = torch.arange(bz, device=h.device)
    if dp is None:
        keys, anchor = h, rows                      # anchors' key indices
    else:
        keys = torch.cat([dp.gather(h[:b]), dp.gather(h[b:])])
        n = b * dp.size
        anchor = torch.cat([rows[:b] + dp.rank * b,
                            rows[:b] + n + dp.rank * b])
    nk = keys.shape[0]
    sims = torch.einsum("bld,cld->lbc", h, keys)               # [L, 2b, 2B]
    diag = (anchor[:, None] == torch.arange(nk, device=h.device))[None]
    sims = torch.where(diag, torch.full_like(sims, -1e9), sims)
    twin = (anchor + nk // 2) % nk
    picked = torch.log_softmax(sims, dim=-1)[:, rows, twin]    # [L, 2b]
    mask = label_mask.t().float()
    return -(picked * mask).sum() / _total(mask.sum(), dp).clamp_min(1.0)


def rdrop_kl_loss(logits: Tensor) -> Tensor:
    """R-Drop "KL": symmetric KL between the halves' distributions, summed
    over all positions (padding included) and divided by 2·L."""
    b = logits.shape[0] // 2
    sl = logits.shape[1]
    p = torch.log_softmax(logits[:b].float(), dim=-1)
    q = torch.log_softmax(logits[b:].float(), dim=-1)
    kl_pq = (torch.exp(q) * (q - p)).sum()
    kl_qp = (torch.exp(p) * (p - q)).sum()
    return (kl_pq + kl_qp) / 2.0 / sl


def rdrop_l2_loss(logits: Tensor, norm_cols: int | None = None,
                  dp=None) -> Tensor:
    """R-Drop "L2": mean squared difference of the halves' softmax.
    ``norm_cols``: the full vocab width when ``logits`` is the candidate
    slice, so that the mean is taken over the full vocab (its masked
    columns are 0 on both halves)."""
    b = logits.shape[0] // 2
    p = torch.softmax(logits[:b].float(), dim=-1)
    q = torch.softmax(logits[b:].float(), dim=-1)
    sq = (p - q) ** 2
    loss = sq.mean() if dp is None else sq.sum() / _count(sq.numel(), sq,
                                                          dp)
    if norm_cols is not None:
        loss = loss * (logits.shape[-1] / norm_cols)
    return loss


def local_candidate_labels(labels: Tensor, kary: int) -> Tensor:
    """Positional label tokens → candidate slots of the sliced head: digit
    d of position l (token l·kary+2+d) → slot d, EOS → slot kary.  PAD maps
    out of range and is clipped; the caller's label mask drops it."""
    pos = torch.arange(labels.shape[1], device=labels.device,
                       dtype=labels.dtype)
    local = labels - (pos[None, :] * kary + 2)
    local = torch.where(labels == 1, torch.full_like(local, kary), local)
    return local.clamp(0, kary)


def doc_reweight_loss(logits: Tensor, labels: Tensor, label_mask: Tensor,
                      query_emb: Tensor, doc_emb: Tensor, dp=None) -> Tensor:
    """CE weighted per example by relu(cos(query, doc)); the weights'
    global sum is the normaliser, and carries their gradient."""
    ll = _pick(torch.log_softmax(logits.float(), dim=-1), labels)
    q = query_emb / query_emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    d = doc_emb / doc_emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    w = torch.relu((q * d).sum(-1))
    mask = label_mask.float() * w[:, None]
    return -(ll * mask).sum() / _total(mask.sum(), dp).clamp_min(1.0)


def query_token_infonce(query_emb: Tensor, decoder_hidden: Tensor,
                        label_mask: Tensor, dp=None) -> Tensor:
    """Per-position InfoNCE: each query picks its own decoder states out
    of the batch (with ``dp``: out of every rank's rows)."""
    b = query_emb.shape[0]
    keys = decoder_hidden.float()
    rows = torch.arange(b, device=keys.device)
    own = rows
    if dp is not None:
        keys = dp.gather(keys)
        own = rows + dp.rank * b
    logits = torch.einsum("bd,cld->lbc", query_emb.float(), keys)  # [L,b,B]
    picked = torch.log_softmax(logits, dim=-1)[:, rows, own]
    mask = label_mask.t().float()
    return -(picked * mask).sum() / _total(mask.sum(), dp).clamp_min(1.0)


def margin_ranking_loss(pos_prob: Tensor, neg_prob: Tensor,
                        margin: float = 0.5, dp=None) -> Tensor:
    """mean(max(0, margin − (pos − neg))), torch's MarginRankingLoss."""
    hinge = (margin - (pos_prob - neg_prob)).clamp_min(0.0)
    if dp is None:
        return hinge.mean()
    return hinge.sum() / _count(hinge.numel(), hinge, dp)


def denoising_losses(encode: Callable[[Tensor], Tensor],
                     predict_head: Callable[[Tensor], Tensor],
                     disc_head: Callable[[Tensor], Tensor],
                     input_ids: Tensor, attn_mask: Tensor, keep_mask: Tensor,
                     gumbel: Tensor | None = None,
                     generator: torch.Generator | None = None, dp=None
                     ) -> tuple[Tensor, Tensor]:
    """Masked-input reconstruction and corrupted-position discrimination:
    encode the input with the dropped positions (``keep_mask`` False) set
    to 0 and predict the original tokens; replace those positions by
    tokens sampled from the prediction, encode again and classify each
    position as kept or replaced.  The samples are argmax(logits + g):
    ``gumbel`` [B, S, V] f32 when given, else drawn from ``generator``."""
    masked = torch.where(keep_mask, input_ids, torch.zeros_like(input_ids))
    gen_logits = predict_head(encode(masked))                   # [B, S, V]
    gen_loss = masked_cross_entropy(gen_logits, input_ids, attn_mask, dp)
    if gumbel is None:
        gumbel = gumbel_noise(gen_logits.shape, generator)
    sampled = (gen_logits.detach().float() + gumbel).argmax(-1)
    filled = torch.where(keep_mask, input_ids, sampled.to(input_ids.dtype))
    disc_logits = disc_head(encode(filled))                     # [B, S, 2]
    disc_loss = masked_cross_entropy(disc_logits, keep_mask.long(),
                                     attn_mask, dp)
    return gen_loss, disc_loss


def embedding_distillation_loss(encoder_hidden: Tensor, input_ids: Tensor,
                                target_query_emb: Tensor, dp=None) -> Tensor:
    """MSE between the encoder state at each row's first EOS and a target
    query embedding (the positive doc's store row)."""
    first = (input_ids == 1).float().argmax(dim=1)
    rows = torch.arange(len(first), device=first.device)
    end_emb = encoder_hidden[rows, first]
    sq = (end_emb.float() - target_query_emb.float()) ** 2
    if dp is None:
        return sq.mean()
    return sq.sum() / _count(sq.numel(), sq, dp)


def weight_distillation_loss(head_vectors: Tensor, target_emb: Tensor,
                             mask: Tensor, dp=None) -> Tensor:
    """Masked MSE between the adapted lm-head vectors of the label tokens
    and the trie's prefix-node embeddings.  [B, L, d], mask [B, L]."""
    diff = (head_vectors.float() - target_emb.float()) ** 2
    m = mask.float()[..., None]
    return (diff * m).sum() / (_total(m.sum(), dp)
                               * diff.shape[-1]).clamp_min(1.0)


def cluster_infonce(query: Tensor, positive: Tensor, candidates: Tensor,
                    candidate_mask: Tensor, tau: float = 0.05,
                    intra_rate: float = 1.0, squash: str = "tanh",
                    dp=None) -> Tensor:
    """Cluster-adaptive contrastive loss over the dense space, with
    s = squash(q·d):

        loss_i = −s(q_i,p_i)/τ + log(intra_rate·Σ_intra e^{s/τ} + Σ_inter e^{s/τ})

    where intra are query i's own candidates and inter every other query's.
    query, positive [B, d]; candidates [B, C, d]; candidate_mask [B, C].
    With ``dp``, ``query`` and ``positive`` are this rank's [b, d] rows and
    ``candidates`` / ``candidate_mask`` the global batch's (gathered by
    the caller through ``dp.gather`` where they carry a gradient)."""
    fn = torch.tanh if squash == "tanh" else torch.sigmoid
    q = query.float()
    pos_sim = fn((q * positive.float()).sum(-1))
    sims = fn(torch.einsum("bd,jcd->bjc", q, candidates.float()))
    cmask = candidate_mask.bool()[None]                         # [1, B, C]
    zero = torch.zeros((), device=q.device)
    exp = torch.where(cmask, torch.exp(sims / tau), zero)       # [b, B, C]
    first = 0 if dp is None else dp.rank * q.shape[0]
    own = (torch.arange(q.shape[0], device=q.device)[:, None] + first
           == torch.arange(candidates.shape[0], device=q.device))[:, :, None]
    intra = torch.where(own, exp, zero).sum(dim=(1, 2))
    inter = torch.where(own, zero, exp).sum(dim=(1, 2))
    denom = intra_rate * intra + inter
    loss = -pos_sim / tau + torch.log(denom.clamp_min(1e-30))
    if dp is None:
        return loss.mean()
    return loss.sum() / _count(loss.numel(), loss, dp)
