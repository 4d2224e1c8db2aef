"""The CID prefix trie as dense host arrays.

A copy of ``gdr_tpu/ops/trie.py``'s index-build and expansion path: the
arrays, their host helpers, ``build_trie`` (its node graph packed by the
port's C++ library, ``native.py``), the node embeddings, the greedy
``tree_match`` and ``insert_docs``, and the training path's
``prefix_node_embeddings`` (weight distillation's targets).  Node numbering is BFS with per-level
insertion in sorted-CID order, so the arrays equal the reference package's
for the same mapping.

- ``children``      int32 [N, kary]   — child node per digit, -1 if absent
- ``eos_allowed``   bool  [N]         — a complete CID ends at this node
- ``depth``         int32 [N]
- ``node_embedding`` float32 [N, d]   — leaf-count-weighted mean of the doc
                                        embeddings below a node
- ``leaf_count``    int32 [N]
- CSR doc map ``doc_start``/``doc_count`` [N] into ``doc_indices``
- padded per-cluster doc table: ``cluster_of_node`` [N] (-1 if not a
  cluster), ``cluster_docs`` [C, cap], ``cluster_doc_mask`` [C, cap],
  ``cluster_node_ids`` [C]

Node 0 is the root; every parent's id is smaller than its children's, so
bottom-up passes are one reversed loop.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np

from gdr_tpu_torch import native
from gdr_tpu_torch.ops.codec import TOKEN_OFFSET


@dataclass
class TrieTensors:
    kary: int
    children: np.ndarray          # int32 [N, kary]
    eos_allowed: np.ndarray       # bool  [N]
    depth: np.ndarray             # int32 [N]
    doc_start: np.ndarray         # int32 [N]
    doc_count: np.ndarray         # int32 [N]
    doc_indices: np.ndarray       # int32 [total_docs]
    cluster_of_node: np.ndarray   # int32 [N]
    cluster_node_ids: np.ndarray  # int32 [C]
    cluster_docs: np.ndarray      # int32 [C, cap]
    cluster_doc_mask: np.ndarray  # bool  [C, cap]
    node_embedding: np.ndarray | None = None   # float32 [N, d]
    leaf_count: np.ndarray | None = None       # int32 [N]

    @property
    def num_nodes(self) -> int:
        return self.children.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.cluster_node_ids.shape[0]

    @property
    def max_docs_per_cluster(self) -> int:
        return self.cluster_docs.shape[1]

    def node_of_path(self, digits: Sequence[int]) -> int:
        """Walk a digit path from the root; -1 if it leaves the trie."""
        cur = 0
        for d in digits:
            cur = int(self.children[cur, int(d)])
            if cur < 0:
                return -1
        return cur

    def parent_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(parent_id [N], digit [N]) from one vectorised pass, memoised on
        the instance (``dataclasses.replace`` drops the memo, so a trie of
        another structure recomputes).  Corpus expansion asks for the CID
        of every cluster: rebuilding the map per call made a 2,048-doc
        insert into 50k docs take hours."""
        cached = getattr(self, "_parent_arrays", None)
        if cached is not None:
            return cached
        n = self.num_nodes
        parent = np.full(n, -1, np.int32)
        digit = np.full(n, -1, np.int32)
        src, dig = np.nonzero(self.children >= 0)
        kids = self.children[src, dig]
        parent[kids] = src
        digit[kids] = dig
        self._parent_arrays = (parent, digit)
        return parent, digit

    def cid_of_node(self, node: int) -> str:
        """The dash-joined CID of a node."""
        parent, digit = self.parent_arrays()
        digits = []
        while node != 0:
            digits.append(int(digit[node]))
            node = int(parent[node])
        return "-".join(str(d) for d in reversed(digits))

    def cids_of_nodes(self, nodes: Iterable[int]) -> list[str]:
        return [self.cid_of_node(int(n)) for n in nodes]

    def docs_of_cid(self, cid: str) -> list[int]:
        digits = [int(c) for c in cid.split("-")] if cid else []
        node = self.node_of_path(digits)
        if node < 0:
            return []
        s, c = int(self.doc_start[node]), int(self.doc_count[node])
        return [int(i) for i in self.doc_indices[s:s + c]]

    def id_mapping(self) -> dict[str, list[int]]:
        """The reference's ``indexmap.pkl`` dict (CID → doc ids)."""
        return {self.cid_of_node(int(n)): self.docs_of_cid(self.cid_of_node(int(n)))
                for n in self.cluster_node_ids}


def _cid_paths(cid_to_docs: Mapping[str, Iterable[int]], kary: int
               ) -> tuple[dict[str, list[int]], list[str]]:
    paths = {cid: [int(c) for c in cid.split("-")] if cid else []
             for cid in cid_to_docs}
    for cid, digits in paths.items():
        for d in digits:
            if not (0 <= d < kary):
                raise ValueError(
                    f"digit {d} out of range for kary={kary} (cid={cid})")
    return paths, sorted(paths)


def build_trie(cid_to_docs: Mapping[str, Iterable[int]], kary: int,
               max_docs_per_cluster: int = 64,
               doc_embeddings: np.ndarray | None = None) -> TrieTensors:
    """Build trie arrays from a {CID string: [doc indices]} mapping: every
    CID becomes a root-to-node path and its documents attach at the
    terminal node.  The node graph is packed by the host C++ library; with
    ``doc_embeddings`` the node embeddings are computed too."""
    paths, sorted_cids = _cid_paths(cid_to_docs, kary)
    built = native.build_trie_arrays([paths[c] for c in sorted_cids], kary)
    # the library's CSR groups the CID rows; map terminal nodes back to CIDs
    docs_at: dict[int, list[int]] = {}
    for node in np.nonzero(built["doc_count"] > 0)[0]:
        s, c = int(built["doc_start"][node]), int(built["doc_count"][node])
        if c != 1:
            raise ValueError(f"{c} CIDs end at node {node}: the mapping "
                             f"spells one digit path in two ways")
        cid = sorted_cids[int(built["doc_indices"][s])]
        docs_at[int(node)] = [int(i) for i in cid_to_docs[cid]]
    trie = _doc_tables(kary, built["children"], built["depth"],
                       built["eos_allowed"], docs_at, max_docs_per_cluster)
    if doc_embeddings is not None:
        trie = compute_node_embeddings(trie, doc_embeddings)
    return trie


def _build_trie_python(cid_to_docs: Mapping[str, Iterable[int]], kary: int,
                       max_docs_per_cluster: int = 64) -> TrieTensors:
    """``build_trie``'s node graph in pure Python: the oracle the tests hold
    the C++ packer to."""
    paths, sorted_cids = _cid_paths(cid_to_docs, kary)
    child_maps: list[dict[int, int]] = [{}]
    depths = [0]
    max_depth = max((len(p) for p in paths.values()), default=0)
    for level in range(max_depth):
        for cid in sorted_cids:
            digits = paths[cid]
            if level >= len(digits):
                continue
            cur = 0
            for d in digits[:level]:
                cur = child_maps[cur][d]
            d = digits[level]
            if d not in child_maps[cur]:
                child_maps.append({})
                depths.append(level + 1)
                child_maps[cur][d] = len(child_maps) - 1
    docs_at: dict[int, list[int]] = {}
    for cid, digits in paths.items():
        cur = 0
        for d in digits:
            cur = child_maps[cur][d]
        docs_at.setdefault(cur, []).extend(int(i) for i in cid_to_docs[cid])

    n = len(child_maps)
    children = np.full((n, kary), -1, dtype=np.int32)
    for node, cm in enumerate(child_maps):
        for d, c in cm.items():
            children[node, d] = c
    eos_allowed = np.zeros(n, dtype=bool)
    eos_allowed[list(docs_at)] = True
    return _doc_tables(kary, children, np.asarray(depths, dtype=np.int32),
                       eos_allowed, docs_at, max_docs_per_cluster)


def _doc_tables(kary: int, children: np.ndarray, depth: np.ndarray,
                eos_allowed: np.ndarray, docs_at: dict[int, list[int]],
                cap: int) -> TrieTensors:
    """The CSR doc map and the padded cluster table of a packed node
    graph."""
    n = children.shape[0]
    doc_start = np.zeros(n, dtype=np.int32)
    doc_count = np.zeros(n, dtype=np.int32)
    flat_docs: list[int] = []
    cluster_node_ids = np.asarray(sorted(docs_at.keys()), dtype=np.int32)
    cluster_of_node = np.full(n, -1, dtype=np.int32)
    c_num = len(cluster_node_ids)
    cluster_docs = np.zeros((max(c_num, 1), cap), dtype=np.int32)
    cluster_doc_mask = np.zeros((max(c_num, 1), cap), dtype=bool)
    for row, node in enumerate(cluster_node_ids):
        docs = docs_at[int(node)]
        doc_start[node] = len(flat_docs)
        doc_count[node] = len(docs)
        flat_docs.extend(docs)
        cluster_of_node[node] = row
        take = min(len(docs), cap)
        cluster_docs[row, :take] = docs[:take]
        cluster_doc_mask[row, :take] = True
    return TrieTensors(
        kary=kary,
        children=children,
        eos_allowed=eos_allowed,
        depth=depth,
        doc_start=doc_start,
        doc_count=doc_count,
        doc_indices=np.asarray(flat_docs, dtype=np.int32),
        cluster_of_node=cluster_of_node,
        cluster_node_ids=cluster_node_ids,
        cluster_docs=cluster_docs,
        cluster_doc_mask=cluster_doc_mask,
    )


def compute_node_embeddings(trie: TrieTensors, doc_embeddings: np.ndarray
                            ) -> TrieTensors:
    """Bottom-up leaf-count-weighted node embeddings (the reference's
    ``tree_embedding_calculate``): a node with directly attached docs takes
    the mean of those (its children, if any, are ignored); any other node
    the leaf-count-weighted mean of its children.  Sums are f64."""
    doc_embeddings = np.asarray(doc_embeddings)
    n = trie.num_nodes
    d = doc_embeddings.shape[1]
    emb_sum = np.zeros((n, d), dtype=np.float64)
    leaf = np.zeros(n, dtype=np.int64)
    for node in trie.cluster_node_ids:
        s, c = int(trie.doc_start[node]), int(trie.doc_count[node])
        idx = trie.doc_indices[s:s + c]
        emb_sum[node] = doc_embeddings[idx].sum(axis=0)
        leaf[node] = c
    for node in range(n - 1, -1, -1):
        if leaf[node] > 0:      # direct docs win (reference semantics)
            continue
        ch = trie.children[node]
        ch = ch[ch >= 0]
        if len(ch):
            emb_sum[node] = emb_sum[ch].sum(axis=0)
            leaf[node] = leaf[ch].sum()
    with np.errstate(invalid="ignore", divide="ignore"):
        emb = emb_sum / np.maximum(leaf, 1)[:, None]
    return dataclasses.replace(
        trie,
        node_embedding=emb.astype(np.float32),
        leaf_count=leaf.astype(np.int32),
    )


def tree_match(trie: TrieTensors, doc_embed: np.ndarray) -> list[int]:
    """Greedy root-to-leaf descent by dot similarity (the reference's
    ``tree_match``): at each node the child with the largest ⟨doc, child
    embedding⟩, until no child has docs below it.  Returns the digit
    path."""
    if trie.node_embedding is None:
        raise ValueError("trie has no node embeddings (build_trie with "
                         "doc_embeddings=, or compute_node_embeddings)")
    cur, path = 0, []
    while True:
        ch = trie.children[cur]
        valid = np.nonzero((ch >= 0) & (trie.leaf_count[np.maximum(ch, 0)] > 0))[0]
        if len(valid) == 0:
            return path
        sims = trie.node_embedding[ch[valid]] @ np.asarray(doc_embed)
        d = int(valid[int(np.argmax(sims))])
        path.append(d)
        cur = int(ch[d])


def insert_docs(trie: TrieTensors, new_doc_embeddings: np.ndarray,
                first_new_index: int) -> tuple[TrieTensors, np.ndarray]:
    """Corpus expansion without retraining (the reference's
    ``tree_embedding_insert``): each new document joins the cluster whose
    node embedding has the largest dot with it, new ids ``first_new_index
    + m``.  The trie's structure is unchanged; the doc tables are rebuilt
    (the cluster table's cap grows to the largest cluster) and the node
    embeddings are kept, not recomputed.  Returns the new trie and each new
    doc's cluster row."""
    if trie.node_embedding is None:
        raise ValueError("trie has no node embeddings (build_trie with "
                         "doc_embeddings=, or compute_node_embeddings)")
    new_doc_embeddings = np.asarray(new_doc_embeddings)
    cluster_emb = trie.node_embedding[trie.cluster_node_ids]       # [C, d]
    sims = new_doc_embeddings @ cluster_emb.T                      # [M, C]
    rows = np.argmax(sims, axis=1).astype(np.int32)                # [M]

    cluster_cids = trie.cids_of_nodes(trie.cluster_node_ids)
    cid_docs: dict[str, list[int]] = {}
    seen: dict[str, set[int]] = {}
    for cid, node in zip(cluster_cids, trie.cluster_node_ids):
        s, c = int(trie.doc_start[node]), int(trie.doc_count[node])
        docs = [int(i) for i in trie.doc_indices[s:s + c]]
        cid_docs[cid] = docs
        seen[cid] = set(docs)
    for m, row in enumerate(rows):
        cid = cluster_cids[int(row)]
        doc_id = first_new_index + m
        if doc_id not in seen[cid]:            # the reference dedups by set
            cid_docs[cid].append(doc_id)
            seen[cid].add(doc_id)

    cap = trie.max_docs_per_cluster
    new_max = max(max((len(v) for v in cid_docs.values()), default=0), cap)
    out = build_trie(cid_docs, trie.kary, max_docs_per_cluster=new_max)
    out = dataclasses.replace(out, node_embedding=trie.node_embedding,
                              leaf_count=trie.leaf_count)
    return out, rows


def prefix_node_embeddings(trie: TrieTensors, labels: np.ndarray,
                           label_mask: np.ndarray, kary: int,
                           position: bool = True
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Per-position prefix-node embeddings for weight distillation.

    For each row's positional CID label sequence, position ``l`` is scored
    by an lm-head adapted to the prefix ``digits[:l]`` — its distillation
    target is the embedding of the trie node that prefix reaches (the
    reference's ``prefix_embedding[prefix2idx_dict[target[:i]]]``, kept
    commented out behind np.random fakes at main_models.py:505-519;
    node embeddings per tree_embedding_calculate, :154-179).

    labels/label_mask: [B, L].  Returns (emb [B, L, d'], mask [B, L]) —
    mask zero where the label is EOS/padding or the prefix left the trie.
    """
    assert trie.node_embedding is not None, (
        "trie has no node embeddings (build with doc_embeddings)")
    b, l_max = labels.shape
    d = trie.node_embedding.shape[1]
    emb = np.zeros((b, l_max, d), np.float32)
    mask = np.zeros((b, l_max), np.float32)
    node = np.zeros(b, np.int64)                 # root
    alive = np.ones(b, bool)
    for l in range(l_max):
        tok = labels[:, l].astype(np.int64)
        digit = tok - (l * kary if position else 0) - TOKEN_OFFSET
        is_digit = (digit >= 0) & (digit < kary) & (label_mask[:, l] > 0)
        take = alive & is_digit
        emb[take, l] = trie.node_embedding[node[take]]
        mask[:, l] = take.astype(np.float32)
        nxt = trie.children[node, np.clip(digit, 0, kary - 1)]
        node = np.where(take, nxt, node)
        alive = take & (node >= 0)
        node = np.clip(node, 0, None)
    return emb, mask
