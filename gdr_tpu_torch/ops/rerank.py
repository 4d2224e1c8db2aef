"""Stage 2: dense re-rank of in-cluster documents + score fusion, mirroring
``gdr_tpu/ops/rerank.py``.

Each beam's cluster expands to its documents; every candidate is scored
``tanh(q·d)``; the fused score per weight α adds ``α · softmax(beam
scores)[beam]``; the top ``top_r`` documents are kept per α.  Documents
belong to one cluster and beams are distinct clusters, so no dedup.  The
query is one row per query ``[B, d]`` or one per beam ``[B, K, d]``.

- :func:`rerank` gathers candidates through the padded cluster table.  A
  plain store is scored by ``kernels/rerank.py::rerank_scores``, which
  streams the candidate rows; a :class:`QuantizedStore` by
  :func:`quantized_dot` in plain PyTorch (the reference leaves it to XLA);
- :func:`rerank_packed` reads each beam's one contiguous ``[cap, d]`` block
  of the cluster-packed store through ``packed_scores``, or, for a
  :class:`PackedQuantizedStore`, the raw int8 dots through
  ``packed_scores_int8`` and then the per-row scale and the tanh.

Each scorer is the hand-written kernel on a CUDA device and its plain
version on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gdr_tpu_torch.kernels.rerank import (packed_scores, packed_scores_int8,
                                           rerank_scores)
from gdr_tpu_torch.ops.quantize import (PackedQuantizedStore, QuantizedStore,
                                        quantized_dot)

NEG_INF = -1.0e9


@dataclass
class RerankResult:
    doc_ids: torch.Tensor       # [A, B, R] int32 — top docs per fusion weight
    scores: torch.Tensor        # [A, B, R] f32 — fused scores
    doc_valid: torch.Tensor     # [A, B, R] bool
    cluster_probs: torch.Tensor  # [B, K] — softmax over beam scores


def padded_top_k(scores: torch.Tensor, payload: torch.Tensor, k: int):
    """Top-k along the last axis where ``k`` may exceed its length: missing
    slots get NEG_INF scores and payload 0."""
    n = scores.shape[-1]
    if n < k:
        pad = k - n
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
        payload = torch.nn.functional.pad(payload, (0, pad), value=0)
    top_scores, top_idx = torch.topk(scores, k, dim=-1)
    return top_scores, torch.gather(payload, -1, top_idx)


def expand_candidates(nodes, valid, cluster_of_node, cluster_docs,
                      cluster_doc_mask):
    """Beam cluster nodes [B, K] → candidate docs and mask [B, K, cap]."""
    rows = cluster_of_node[nodes.long()]
    ok = valid & (rows >= 0)
    rows = rows.clamp_min(0).long()
    docs = cluster_docs[rows]
    mask = cluster_doc_mask[rows] & ok[..., None]
    return docs, mask


def _beam_probs(beam_scores, valid):
    s = torch.where(valid, beam_scores, torch.full_like(beam_scores, NEG_INF))
    return torch.softmax(s.float(), dim=-1)


def _per_beam(query_emb: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """Per-beam query rows [B, K, d] from [B, d] or [B, K, d]."""
    if query_emb.dim() == 3:
        return query_emb
    return query_emb[:, None, :].expand(b, k, query_emb.shape[-1])


def _fuse_top(sim, mask, probs, payload, alphas, top_r):
    fused = sim[None] + alphas[:, None, None, None] * probs[None, :, :, None]
    fused = torch.where(mask[None], fused, torch.full_like(fused, NEG_INF))
    a, b = fused.shape[:2]
    flat = fused.reshape(a, b, -1)
    flat_payload = payload.reshape(1, b, -1).expand(a, -1, -1)
    return padded_top_k(flat, flat_payload, top_r)


def rerank(doc_store, query_emb, nodes, beam_scores, valid, cluster_of_node,
           cluster_docs, cluster_doc_mask, alphas, top_r: int
           ) -> RerankResult:
    """Fused dense re-rank + α-sweep over the plain store: a [N, d] tensor
    or a :class:`QuantizedStore`.  query_emb: [B, d] or [B, K, d];
    nodes/beam_scores/valid: [B, K]."""
    docs, mask = expand_candidates(nodes, valid, cluster_of_node,
                                   cluster_docs, cluster_doc_mask)
    b, k, cap = docs.shape
    probs = _beam_probs(beam_scores, valid)
    q_bk = _per_beam(query_emb, b, k)
    if isinstance(doc_store, QuantizedStore):
        sim = torch.tanh(quantized_dot(q_bk, doc_store, docs))
        sim = torch.where(mask, sim, torch.full_like(sim, NEG_INF))
    else:
        sim = rerank_scores(doc_store, docs.reshape(b * k, cap).to(torch.int32),
                            q_bk.reshape(b * k, -1),
                            mask.reshape(b * k, cap)).reshape(b, k, cap)
    top_scores, top_docs = _fuse_top(sim, mask, probs, docs, alphas, top_r)
    return RerankResult(doc_ids=top_docs.to(torch.int32), scores=top_scores,
                        doc_valid=top_scores > NEG_INF / 2,
                        cluster_probs=probs)


def rerank_packed(packed_rows, packed_starts, packed_counts, row_to_doc,
                  cap: int, query_emb, nodes, beam_scores, valid,
                  cluster_of_node, alphas, top_r: int) -> RerankResult:
    """Re-rank over the cluster-packed store (ops/packed_store.py): a
    [M, d] tensor or a :class:`PackedQuantizedStore`.  Results in original
    doc ids via ``row_to_doc``."""
    b, k = nodes.shape
    rows = cluster_of_node[nodes.long()]
    ok = valid & (rows >= 0)
    rows_c = rows.clamp_min(0).long()
    start = packed_starts[rows_c]                            # [B, K] int32
    count = packed_counts[rows_c]
    offs = torch.arange(cap, device=nodes.device)
    mask = (offs[None, None, :] < count[..., None]) & ok[..., None]
    probs = _beam_probs(beam_scores, valid)
    q_bk = _per_beam(query_emb, b, k)
    flat_rows = start[..., None].long() + offs                # [B, K, cap]
    starts, q_rows = start.reshape(-1).contiguous(), q_bk.reshape(b * k, -1)
    if isinstance(packed_rows, PackedQuantizedStore):
        # raw int8 dots, then the per-row dequantising scale and the tanh
        raw = packed_scores_int8(packed_rows.values, starts, q_rows, cap)
        sim = torch.tanh(raw.reshape(b, k, cap)
                         * packed_rows.scales[flat_rows])
    else:
        sim = packed_scores(packed_rows, starts, q_rows,
                            cap).reshape(b, k, cap)
    sim = torch.where(mask, sim, torch.full_like(sim, NEG_INF))
    top_scores, top_rows = _fuse_top(sim, mask, probs, flat_rows, alphas,
                                     top_r)
    top_docs = row_to_doc[top_rows]
    return RerankResult(doc_ids=top_docs.to(torch.int32), scores=top_scores,
                        doc_valid=top_scores > NEG_INF / 2,
                        cluster_probs=probs)
