"""Cluster-packed document store: each beam's candidates are one contiguous
block of rows.

A copy of ``pack_layout``, ``pack_layout_sharded`` and
``pack_store_by_cluster`` from ``gdr_tpu/ops/packed_store.py``, and
``pack_rows`` in PyTorch.  Every cluster's documents occupy one block that
starts on an ``align``-row boundary; the re-rank scorer then reads one
contiguous ``[cap, d]`` block per beam (kernels/rerank.py).  The layout
leaves a ``cap``-row tail margin so ``start + cap`` never runs past the end;
the scorer relies on it and does no bounds masking.  The sharded layout
keeps every cluster inside one of ``n_shards`` equal row ranges, each with
its own tail margin, so a rank scores its beams in its own rows
(parallel/store.py).  Pad rows are zero.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gdr_tpu_torch.ops.trie import TrieTensors

ALIGN = 8


@dataclass
class PackedStore:
    rows: np.ndarray          # [M, d] cluster-contiguous embeddings
    starts: np.ndarray        # [C] int32 align-row start per cluster
    counts: np.ndarray        # [C] int32 real docs per cluster
    row_to_doc: np.ndarray    # [M] int32 original doc id per row (-1 pad)
    cap: int                  # max padded cluster size (the block length)

    @property
    def num_rows(self) -> int:
        return self.rows.shape[0]


def pack_layout(trie: TrieTensors, cap: int | None = None,
                align: int = ALIGN
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Packed layout from the trie alone.  Returns (starts [C],
    counts [C], row_to_doc [M] (-1 for pad rows), cap)."""
    c = trie.num_clusters
    counts = np.zeros(c, np.int32)
    starts = np.zeros(c, np.int32)
    cursor = 0
    max_count = 0
    for row, node in enumerate(trie.cluster_node_ids):
        cnt = int(trie.doc_count[node])
        counts[row] = cnt
        starts[row] = cursor
        cursor += -(-cnt // align) * align
        max_count = max(max_count, cnt)
    cap = cap or max(-(-max_count // align) * align, align)
    m = cursor + cap            # tail margin so start+cap never overruns
    row_to_doc = np.full(m, -1, np.int32)
    for row, node in enumerate(trie.cluster_node_ids):
        s, cnt = int(trie.doc_start[node]), int(trie.doc_count[node])
        row_to_doc[starts[row]:starts[row] + cnt] = trie.doc_indices[s:s + cnt]
    return starts, counts, row_to_doc, cap


def pack_rows(store: torch.Tensor, row_to_doc: torch.Tensor) -> torch.Tensor:
    """Materialise packed rows with one gather of the original store on its
    own device (pad rows → zeros)."""
    r = row_to_doc.to(store.device)
    rows = store[r.clamp_min(0)]
    return torch.where((r >= 0)[:, None], rows, torch.zeros_like(rows))


def pack_store_by_cluster(trie: TrieTensors, store: np.ndarray,
                          cap: int | None = None) -> PackedStore:
    """Layout and rows on the host, in numpy: the reference's helper,
    kept for parity (no entry point calls it; the Evaluator packs on the
    device with :func:`pack_rows`)."""
    store = np.asarray(store)
    starts, counts, row_to_doc, cap = pack_layout(trie, cap)
    rows = np.zeros((len(row_to_doc), store.shape[1]), store.dtype)
    real = row_to_doc >= 0
    rows[real] = store[row_to_doc[real]]
    return PackedStore(rows=rows, starts=starts, counts=counts,
                       row_to_doc=row_to_doc, cap=cap)


def pack_layout_sharded(trie: TrieTensors, n_shards: int,
                        cap: int | None = None, align: int = ALIGN
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                   int, int]:
    """Shard-aware packed layout: every cluster's block lies inside one of
    ``n_shards`` equal row ranges.  Clusters are bin-packed greedily
    (largest padded block first, each to the least-loaded shard); every
    range is padded to a common ``shard_rows`` that leaves a ``cap``-row
    tail margin, so ``start + cap`` never crosses into the next shard.

    Returns (starts [C] global row starts, counts [C], row_to_doc
    [n_shards·shard_rows] (-1 for pad rows), cap, shard_rows)."""
    c = trie.num_clusters
    counts = np.zeros(c, np.int32)
    padded = np.zeros(c, np.int64)
    for row, node in enumerate(trie.cluster_node_ids):
        cnt = int(trie.doc_count[node])
        counts[row] = cnt
        padded[row] = -(-max(cnt, 1) // align) * align
    max_count = int(counts.max()) if c else 0
    cap = cap or max(-(-max_count // align) * align, align)
    loads = np.zeros(n_shards, np.int64)
    bin_of = np.zeros(c, np.int32)
    offset = np.zeros(c, np.int64)
    for r in np.argsort(-padded, kind="stable"):
        b = int(np.argmin(loads))
        bin_of[r] = b
        offset[r] = loads[b]
        loads[b] += padded[r]
    shard_rows = int(-(-(int(loads.max()) + cap) // align) * align)
    starts = (bin_of.astype(np.int64) * shard_rows + offset).astype(np.int32)
    row_to_doc = np.full(n_shards * shard_rows, -1, np.int32)
    for row, node in enumerate(trie.cluster_node_ids):
        s, cnt = int(trie.doc_start[node]), int(trie.doc_count[node])
        row_to_doc[starts[row]:starts[row] + cnt] = \
            trie.doc_indices[s:s + cnt]
    return starts, counts, row_to_doc, cap, shard_rows
