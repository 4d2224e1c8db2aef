"""Row-sharded document store and its distributed re-rank, mirroring
``gdr_tpu/parallel/store.py``.

The store is the largest buffer of the system, so it is row-sharded over
the mesh and never replicated: each rank holds only its rows, built from
the host store without a whole copy on the device.  Every rank decodes the
whole batch (weights and queries are replicated), then each re-rank is a
**shard-local body** and a **merge**:

- the body scores only the candidates whose rows the rank owns, through
  the layout's scorer (``kernels/rerank.py``: ``rerank_scores`` on the
  plain store, ``packed_scores`` / ``packed_scores_int8`` on the packed
  ones), and keeps its top ``min(top_r, K·cap)`` fused scores with their
  doc ids (plain) or global packed rows (packed);
- the merge gathers every rank's winners with one ``all_gather`` of the
  scores and their ids, in rank order, and keeps the top ``top_r``.

Only ``O(ranks × A × B × R)`` scalars cross between ranks.  The bodies
take their shard index, so the tests run every shard in one process and
merge by hand.  Padded rows never win: no real doc id points at them.
"""

from __future__ import annotations

import numpy as np
import torch

from gdr_tpu_torch.kernels.rerank import (packed_scores, packed_scores_int8,
                                           rerank_scores)
from gdr_tpu_torch.ops.quantize import PackedQuantizedStore, quantize_store
from gdr_tpu_torch.ops.rerank import (NEG_INF, RerankResult, _beam_probs,
                                      _fuse_top, _per_beam, expand_candidates,
                                      padded_top_k)


def pad_store(store: np.ndarray, num_shards: int) -> np.ndarray:
    """Store rows padded with zeros to a multiple of ``num_shards``: the
    reference's whole padded store, kept for parity; :func:`place_store`
    pads only the rank's rows."""
    n = store.shape[0]
    rem = (-n) % num_shards
    if rem == 0:
        return store
    return np.concatenate([store, np.zeros((rem, store.shape[1]),
                                           store.dtype)])


def _gather_rows(store, idx: np.ndarray, device) -> torch.Tensor:
    """``store[idx]`` on ``device``, zero rows where ``idx < 0``.  A numpy
    store (a memory map too) is read only at those rows; a tensor is
    indexed on its own device."""
    safe = np.maximum(idx, 0)
    if isinstance(store, torch.Tensor):
        rows = store[torch.as_tensor(safe, device=store.device)].to(device)
    else:
        rows = torch.from_numpy(np.asarray(store)[safe]).to(device)
    pad = torch.as_tensor(idx < 0, device=device)
    rows[pad] = 0
    return rows


def place_store(store, mesh, device=None) -> torch.Tensor:
    """This rank's rows of the plain store, padded as ``pad_store`` pads
    it: [ceil(N / size), d] on ``device`` (default the mesh's)."""
    lo, hi = mesh.store_range(store.shape[0])
    idx = np.arange(lo, hi)
    idx[idx >= store.shape[0]] = -1
    return _gather_rows(store, idx, device or mesh.device)


def place_packed_store(store, row_to_doc: np.ndarray, mesh, device=None,
                       quantize: bool = False):
    """This rank's ``shard_rows`` rows of the shard-aware packed layout
    (``ops/packed_store.py::pack_layout_sharded``), built from the plain
    store ``store`` [N, d] through ``row_to_doc``; with ``quantize`` as a
    :class:`PackedQuantizedStore` (per-row int8, so quantizing the rank's
    rows equals quantizing the whole store and slicing; pad rows get zero
    values and scale)."""
    shard_rows = len(row_to_doc) // mesh.size
    lo = mesh.rank * shard_rows
    local = np.asarray(row_to_doc[lo:lo + shard_rows])
    rows = _gather_rows(store, local, device or mesh.device)
    if not quantize:
        return rows
    q = quantize_store(rows)
    q.scales[torch.as_tensor(local < 0, device=rows.device)] = 0
    return PackedQuantizedStore(values=q.values, scales=q.scales)


def gather_merge(mesh, scores: torch.Tensor, payload: torch.Tensor,
                 top_r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge: every rank's local winners ([A, B, r] scores and int32
    ids or rows) gathered in one ``all_gather`` (the ids ride as the bits
    of f32 values) and re-ranked to the top ``top_r``.  Returns (scores,
    payload) [A, B, top_r]."""
    both = torch.stack([scores.float(),
                        payload.to(torch.int32).view(torch.float32)])
    g = mesh.all_gather(both)
    return padded_top_k(g[0], g[1].view(torch.int32), top_r)


def rerank_shard(store_local: torch.Tensor, shard: int, query_emb, docs,
                 mask, probs, alphas, top_r: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The body of :func:`sharded_rerank` on shard ``shard``, whose rows
    are ``store_local`` [rows, d]: candidates [B, K, cap] outside
    [shard·rows, (shard+1)·rows) are masked.  Returns the local top
    ``min(top_r, K·cap)`` fused scores and doc ids, [A, B, r]."""
    rows = store_local.shape[0]
    b, k, cap = docs.shape
    local = docs.long() - shard * rows
    owned = mask & (local >= 0) & (local < rows)
    local = local.clamp(0, rows - 1).to(torch.int32)
    q_bk = _per_beam(query_emb, b, k)
    sim = rerank_scores(store_local, local.reshape(b * k, cap),
                        q_bk.reshape(b * k, -1),
                        owned.reshape(b * k, cap)).reshape(b, k, cap)
    scores, ids = _fuse_top(sim, owned, probs, docs, alphas,
                            min(top_r, k * cap))
    return scores, ids.to(torch.int32)


def sharded_rerank(mesh, store_local, query_emb, docs, mask, probs, alphas,
                   top_r: int) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Distributed fused re-rank over the plain store.  store_local: this
    rank's rows (:func:`place_store`); everything else replicated:
    query_emb [B, d] or [B, K, d], docs / mask [B, K, cap], probs [B, K].
    Returns (doc_ids, scores, valid) [A, B, top_r], equal on every rank."""
    scores, ids = rerank_shard(store_local, mesh.rank, query_emb, docs, mask,
                               probs, alphas, top_r)
    m_scores, m_ids = gather_merge(mesh, scores, ids, top_r)
    return m_ids, m_scores, m_scores > NEG_INF / 2


def sharded_rerank_from_beams(mesh, store_local, query_emb, nodes,
                              beam_scores, valid, cluster_of_node,
                              cluster_docs, cluster_doc_mask, alphas,
                              top_r: int) -> RerankResult:
    """Distributed counterpart of ``ops/rerank.py::rerank``."""
    docs, mask = expand_candidates(nodes, valid, cluster_of_node,
                                   cluster_docs, cluster_doc_mask)
    probs = _beam_probs(beam_scores, valid)
    doc_ids, scores, ok = sharded_rerank(mesh, store_local, query_emb, docs,
                                         mask, probs, alphas, top_r)
    return RerankResult(doc_ids=doc_ids, scores=scores, doc_valid=ok,
                        cluster_probs=probs)


def packed_shard(rows_local, shard: int, shard_rows: int, starts, counts,
                 cap: int, query_emb, nodes, beam_scores, valid,
                 cluster_of_node, alphas, top_r: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The body of :func:`sharded_rerank_packed` on shard ``shard``, whose
    rows are ``rows_local`` ([shard_rows, d] or a
    :class:`PackedQuantizedStore`): a beam is scored here when its
    cluster's block starts in this shard; the others read a clipped block
    inside the shard and are masked.  Returns the local top
    ``min(top_r, K·cap)`` fused scores and global packed rows, [A, B, r]."""
    b, k = nodes.shape
    rows = cluster_of_node[nodes.long()]
    ok = valid & (rows >= 0)
    rows_c = rows.clamp_min(0).long()
    start = starts[rows_c].long()                          # [B, K] global
    count = counts[rows_c]
    owned = ok & (start // shard_rows == shard)
    local = (start - shard * shard_rows).clamp(0, shard_rows - cap)
    offs = torch.arange(cap, device=nodes.device)
    idx = local[..., None] + offs                          # [B, K, cap]
    q_rows = _per_beam(query_emb, b, k).reshape(b * k, -1)
    local_starts = local.reshape(-1).to(torch.int32)
    if isinstance(rows_local, PackedQuantizedStore):
        raw = packed_scores_int8(rows_local.values, local_starts, q_rows, cap)
        sim = torch.tanh(raw.reshape(b, k, cap) * rows_local.scales[idx])
    else:
        sim = packed_scores(rows_local, local_starts, q_rows,
                            cap).reshape(b, k, cap)
    mask = (offs < count[..., None]) & owned[..., None]
    scores, g_rows = _fuse_top(sim, mask, _beam_probs(beam_scores, valid),
                               shard * shard_rows + idx, alphas,
                               min(top_r, k * cap))
    return scores, g_rows.to(torch.int32)


def sharded_rerank_packed(mesh, rows_local, starts, counts, row_to_doc,
                          cap: int, shard_rows: int, query_emb, nodes,
                          beam_scores, valid, cluster_of_node, alphas,
                          top_r: int) -> RerankResult:
    """Distributed re-rank over the shard-aware packed store: every shard
    owns whole clusters, so a beam's candidates are one contiguous block
    of its owner's rows, read by the packed scorer kernel (or the int8
    one, then the shard's scales and the tanh).  ``rows_local``: this
    rank's rows (:func:`place_packed_store`); ``starts`` / ``counts``: the
    layout's global tables; ``row_to_doc`` [size·shard_rows] maps the
    merged rows to doc ids."""
    scores, g_rows = packed_shard(rows_local, mesh.rank, shard_rows, starts,
                                  counts, cap, query_emb, nodes, beam_scores,
                                  valid, cluster_of_node, alphas, top_r)
    m_scores, m_rows = gather_merge(mesh, scores, g_rows, top_r)
    return RerankResult(doc_ids=row_to_doc[m_rows.long()].to(torch.int32),
                        scores=m_scores, doc_valid=m_scores > NEG_INF / 2,
                        cluster_probs=_beam_probs(beam_scores, valid))
