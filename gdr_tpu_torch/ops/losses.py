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
"""

from __future__ import annotations

from typing import Callable

import torch

from gdr_tpu_torch.ops.beam import gumbel_noise

Tensor = torch.Tensor


def _pick(logp: Tensor, labels: Tensor) -> Tensor:
    """logp[..., labels] over the last axis."""
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def masked_cross_entropy(logits: Tensor, labels: Tensor,
                         label_mask: Tensor) -> Tensor:
    """Token CE averaged over the valid positions.  logits [B, L, V];
    labels, label_mask [B, L]."""
    ll = _pick(torch.log_softmax(logits.float(), dim=-1), labels)
    mask = label_mask.float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def rdrop_contrast_loss(decoder_hidden: Tensor, label_mask: Tensor) -> Tensor:
    """R-Drop "Contrast": the batch is two dropout realisations [x; x'];
    per position each row's decoder state must pick its twin among the
    other rows (in-batch InfoNCE between the halves, CE on the logits).
    decoder_hidden [2b, L, d] (already d**-0.5-scaled); label_mask
    [2b, L]."""
    bz = decoder_hidden.shape[0]
    b = bz // 2
    h = decoder_hidden.float()
    sims = torch.einsum("bld,cld->lbc", h, h)                  # [L, 2b, 2b]
    diag = torch.eye(bz, dtype=torch.bool, device=h.device)[None]
    sims = torch.where(diag, torch.full_like(sims, -1e9), sims)
    rows = torch.arange(bz, device=h.device)
    labels = torch.cat([rows[b:], rows[:b]])
    picked = torch.log_softmax(sims, dim=-1)[:, rows, labels]  # [L, 2b]
    mask = label_mask.t().float()
    return -(picked * mask).sum() / mask.sum().clamp_min(1.0)


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


def rdrop_l2_loss(logits: Tensor, norm_cols: int | None = None) -> Tensor:
    """R-Drop "L2": mean squared difference of the halves' softmax.
    ``norm_cols``: the full vocab width when ``logits`` is the candidate
    slice, so that the mean is taken over the full vocab (its masked
    columns are 0 on both halves)."""
    b = logits.shape[0] // 2
    p = torch.softmax(logits[:b].float(), dim=-1)
    q = torch.softmax(logits[b:].float(), dim=-1)
    loss = ((p - q) ** 2).mean()
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
                      query_emb: Tensor, doc_emb: Tensor) -> Tensor:
    """CE weighted per example by relu(cos(query, doc))."""
    ll = _pick(torch.log_softmax(logits.float(), dim=-1), labels)
    q = query_emb / query_emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    d = doc_emb / doc_emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    w = torch.relu((q * d).sum(-1))
    mask = label_mask.float() * w[:, None]
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def query_token_infonce(query_emb: Tensor, decoder_hidden: Tensor,
                        label_mask: Tensor) -> Tensor:
    """Per-position InfoNCE: each query picks its own decoder states out
    of the batch."""
    b = query_emb.shape[0]
    logits = torch.einsum("bd,cld->lbc", query_emb.float(),
                          decoder_hidden.float())            # [L, B, B]
    rows = torch.arange(b, device=logits.device)
    picked = torch.log_softmax(logits, dim=-1)[:, rows, rows]
    mask = label_mask.t().float()
    return -(picked * mask).sum() / mask.sum().clamp_min(1.0)


def margin_ranking_loss(pos_prob: Tensor, neg_prob: Tensor,
                        margin: float = 0.5) -> Tensor:
    """mean(max(0, margin − (pos − neg))), torch's MarginRankingLoss."""
    return (margin - (pos_prob - neg_prob)).clamp_min(0.0).mean()


def denoising_losses(encode: Callable[[Tensor], Tensor],
                     predict_head: Callable[[Tensor], Tensor],
                     disc_head: Callable[[Tensor], Tensor],
                     input_ids: Tensor, attn_mask: Tensor, keep_mask: Tensor,
                     gumbel: Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> tuple[Tensor, Tensor]:
    """Masked-input reconstruction and corrupted-position discrimination:
    encode the input with the dropped positions (``keep_mask`` False) set
    to 0 and predict the original tokens; replace those positions by
    tokens sampled from the prediction, encode again and classify each
    position as kept or replaced.  The samples are argmax(logits + g):
    ``gumbel`` [B, S, V] f32 when given, else drawn from ``generator``."""
    masked = torch.where(keep_mask, input_ids, torch.zeros_like(input_ids))
    gen_logits = predict_head(encode(masked))                   # [B, S, V]
    gen_loss = masked_cross_entropy(gen_logits, input_ids, attn_mask)
    if gumbel is None:
        gumbel = gumbel_noise(gen_logits.shape, generator)
    sampled = (gen_logits.detach().float() + gumbel).argmax(-1)
    filled = torch.where(keep_mask, input_ids, sampled.to(input_ids.dtype))
    disc_logits = disc_head(encode(filled))                     # [B, S, 2]
    disc_loss = masked_cross_entropy(disc_logits, keep_mask.long(),
                                     attn_mask)
    return gen_loss, disc_loss


def embedding_distillation_loss(encoder_hidden: Tensor, input_ids: Tensor,
                                target_query_emb: Tensor) -> Tensor:
    """MSE between the encoder state at each row's first EOS and a target
    query embedding (the positive doc's store row)."""
    first = (input_ids == 1).float().argmax(dim=1)
    rows = torch.arange(len(first), device=first.device)
    end_emb = encoder_hidden[rows, first]
    return ((end_emb.float() - target_query_emb.float()) ** 2).mean()


def weight_distillation_loss(head_vectors: Tensor, target_emb: Tensor,
                             mask: Tensor) -> Tensor:
    """Masked MSE between the adapted lm-head vectors of the label tokens
    and the trie's prefix-node embeddings.  [B, L, d], mask [B, L]."""
    diff = (head_vectors.float() - target_emb.float()) ** 2
    m = mask.float()[..., None]
    return (diff * m).sum() / (m.sum() * diff.shape[-1]).clamp_min(1.0)


def cluster_infonce(query: Tensor, positive: Tensor, candidates: Tensor,
                    candidate_mask: Tensor, tau: float = 0.05,
                    intra_rate: float = 1.0, squash: str = "tanh") -> Tensor:
    """Cluster-adaptive contrastive loss over the dense space, with
    s = squash(q·d):

        loss_i = −s(q_i,p_i)/τ + log(intra_rate·Σ_intra e^{s/τ} + Σ_inter e^{s/τ})

    where intra are query i's own candidates and inter every other query's.
    query, positive [B, d]; candidates [B, C, d]; candidate_mask [B, C]."""
    fn = torch.tanh if squash == "tanh" else torch.sigmoid
    q = query.float()
    pos_sim = fn((q * positive.float()).sum(-1))
    sims = fn(torch.einsum("bd,jcd->bjc", q, candidates.float()))
    cmask = candidate_mask.bool()[None]                         # [1, B, C]
    zero = torch.zeros((), device=q.device)
    exp = torch.where(cmask, torch.exp(sims / tau), zero)       # [B, B, C]
    own = torch.eye(q.shape[0], dtype=torch.bool, device=q.device)[:, :, None]
    intra = torch.where(own, exp, zero).sum(dim=(1, 2))
    inter = torch.where(own, zero, exp).sum(dim=(1, 2))
    denom = intra_rate * intra + inter
    loss = -pos_sim / tau + torch.log(denom.clamp_min(1e-30))
    return loss.mean()
