"""What every cell's traffic is drawn over, and the one generator that
reads a traffic file.

The world is ``chip_smoke.py``'s serving operating point, copied: the
bench's systematic 3-level CIDs (:func:`bench_cid_map`: 334,314 docs in
clusters of at most 30 over 30 × 30 level-2 nodes, 11,144 clusters, depth
3), and a store of random unit rows drawn on the device from the seed.

A traffic file (``gdrbench/traffic/<name>.json``) names the driver that
runs it and its parameters.  Its ``lengths`` table ([[tokens, weight],
…]) gives the query lengths; every query is padded to the configuration's
``max_input_length`` with a mask, so the work of a batch is the same
whatever lengths the seed draws.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, index: int) -> int:
    """A 63-bit seed of stream ``index`` under the run's ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def bench_cid_map(n_docs: int, kary: int, leaf_cap: int
                  ) -> dict[str, list[int]]:
    """The bench's systematic 3-level CIDs: n_docs in clusters of at most
    leaf_cap, spread evenly over kary × kary level-2 nodes."""
    cid_to_docs, doc = {}, 0
    level3 = -(-n_docs // (kary * kary * leaf_cap))
    for i in range(kary):
        for j in range(kary):
            for k in range(level3):
                if doc >= n_docs:
                    break
                take = min(leaf_cap, n_docs - doc)
                cid_to_docs[f"{i}-{j}-{k}"] = list(range(doc, doc + take))
                doc += take
    return cid_to_docs


def unit_store(n_docs: int, dim: int, seed: int, device) -> torch.Tensor:
    """[n_docs, dim] float32 rows of unit norm, drawn on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    store = torch.randn(n_docs, dim, generator=g, device=device)
    return store.div_(store.norm(dim=1, keepdim=True))


def query_lengths(table, n: int, rng: np.random.Generator) -> np.ndarray:
    lens = np.asarray([t for t, _ in table])
    w = np.asarray([float(x) for _, x in table])
    return rng.choice(lens, size=n, p=w / w.sum())


def queries(table, n: int, seq_len: int, vocab: int, seed: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """``n`` queries of lengths from ``table``: token ids uniform in [2,
    vocab) ending in EOS (1), padded with 0 to ``seq_len``; and their
    masks."""
    rng = np.random.default_rng(seed)
    lens = query_lengths(table, n, rng)
    ids = rng.integers(2, vocab, size=(n, seq_len)).astype(np.int32)
    mask = (np.arange(seq_len)[None] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    ids[np.arange(n), lens - 1] = 1
    return ids, mask


def cid_labels(cid: str, kary: int, length: int) -> np.ndarray:
    """The decoder labels of a CID: digit d at position p as token
    p·kary + 2 + d, then EOS (1), padded with 0 to ``length``."""
    toks = [p * kary + 2 + int(d) for p, d in enumerate(cid.split("-"))]
    out = np.zeros(length, np.int32)
    out[:len(toks) + 1] = toks + [1]
    return out


def train_set(table, n: int, seq_len: int, vocab: int, cid_map: dict,
              kary: int, label_len: int, seed: int) -> dict:
    """``n`` training queries (as :func:`queries`), each with a positive
    document drawn uniformly and its CID's labels."""
    ids, mask = queries(table, n, seq_len, vocab, seed)
    cid_of = [None] * sum(len(v) for v in cid_map.values())
    for cid, docs in cid_map.items():
        for d in docs:
            cid_of[d] = cid
    rng = np.random.default_rng(seed + 1)
    pos = rng.integers(0, len(cid_of), n).astype(np.int32)
    labels = np.stack([cid_labels(cid_of[d], kary, label_len) for d in pos])
    return {"input_ids": ids, "attn_mask": mask, "labels": labels,
            "label_mask": (labels > 0).astype(np.int32), "pos_idx": pos,
            "cid_of": cid_of}
