"""Hierarchical k-means for semantic CID assignment, mirroring
``gdr_tpu/ops/kmeans.py``, with the Lloyd iterations on the device of the
store (the card unless the caller asks for the CPU).

The reference recurses a 30-ary scikit-learn k-means on the host while a
cluster holds more than ``leaf_cap`` docs.  Here each level's sibling
clusters are gathered from the device-resident store and fitted together:
one ``[G, b, d]`` batched product per group of same-size-class clusters,
not one launch sequence per cluster.  The host only walks the recursion
tree and sees the assignments.

- Lloyd with k-means++ seeding (``kmeans_fit``): masked weights, distances
  ``|x|² − 2·x·cᵀ + |c|²`` then ``argmin``, empty clusters keep their
  centroid.
- Minibatch k-means (``kmeans_fit_minibatch``, the reference's
  MiniBatchKMeans for clusters of ≥ 1e3 points): per iteration one sampled
  batch moves each centroid toward its batch mean at rate 1/count.
- Corpora under 20,000 docs that no minibatch threshold reaches take
  ``_hierarchical_numpy``, a copy of the reference package's host path, so
  their paths equal ``gdr_tpu``'s bit for bit.

Random draws come from an explicit ``torch.Generator`` (k-means++ points,
minibatch seeds and batches); tests inject the reference package's draws
through ``init`` / ``seed_idx`` / ``batch_idx``.  Output modes:
``doc_level_suffix=False`` (GDR: docs of a leaf share its CID) or ``True``
(NCI: a final digit enumerates each doc inside its leaf).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sample_rows(weights: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """One index per row of ``weights`` [G, n], drawn ∝ the weights (the
    inverse CDF of a uniform draw)."""
    cum = weights.cumsum(-1)
    u = torch.rand(weights.shape[0], 1, generator=generator,
                   device=weights.device) * cum[:, -1:]
    return torch.searchsorted(cum, u, right=True)[:, 0].clamp_max(
        weights.shape[1] - 1)


def _kmeanspp(x: torch.Tensor, w: torch.Tensor, k: int,
              generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeds [G, k, d]: the first point uniform over the mask, then
    each ∝ its squared distance to the nearest seed (uniform again once
    every masked point coincides with a seed)."""
    g, _, d = x.shape
    rows = torch.arange(g, device=x.device)
    cent = x.new_zeros(g, k, d)
    cent[:, 0] = x[rows, _sample_rows(w, generator)]
    mind = ((x - cent[:, :1]) ** 2).sum(-1)                 # [G, n]
    for i in range(1, k):
        p = mind * w
        p = torch.where(p.sum(-1, keepdim=True) > 0, p, w)
        cent[:, i] = x[rows, _sample_rows(p, generator)]
        mind = torch.minimum(mind, ((x - cent[:, i:i + 1]) ** 2).sum(-1))
    return cent


def _assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row: x [G, n, d], cent [G, k, d] → [G, n]."""
    d2 = ((x * x).sum(-1, keepdim=True) - 2.0 * (x @ cent.transpose(1, 2))
          + (cent * cent).sum(-1)[:, None, :])
    return d2.argmin(-1)


def _lloyd(x: torch.Tensor, w: torch.Tensor, cent: torch.Tensor,
           iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked Lloyd iterations from ``cent``; padded rows (weight 0) are
    assigned but move no centroid."""
    k = cent.shape[1]
    for _ in range(iters):
        onehot = F.one_hot(_assign(x, cent), k).float() * w[..., None]
        sums = onehot.transpose(1, 2) @ x                     # [G, k, d]
        counts = onehot.sum(1)                                # [G, k]
        new = sums / counts.clamp_min(1.0)[..., None]
        cent = torch.where(counts[..., None] > 0, new, cent)  # keep empty
    return cent, _assign(x, cent)


def _minibatch(x: torch.Tensor, cent: torch.Tensor, batch_idx: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minibatch iterations from ``cent``: ``batch_idx`` [G, iters, batch]
    are row indices into x [G, n, d]; each centroid moves toward its batch
    mean with rate (its batch count) / (its running count)."""
    g, k = cent.shape[:2]
    rows = torch.arange(g, device=x.device)[:, None]
    counts = x.new_zeros(g, k)
    for i in range(batch_idx.shape[1]):
        pts = x[rows, batch_idx[:, i]]                        # [G, batch, d]
        onehot = F.one_hot(_assign(pts, cent), k).float()
        bsum = onehot.transpose(1, 2) @ pts
        bcnt = onehot.sum(1)
        counts = counts + bcnt
        lr = (bcnt / counts.clamp_min(1.0))[..., None]
        bmean = bsum / bcnt.clamp_min(1.0)[..., None]
        cent = torch.where(bcnt[..., None] > 0,
                           (1.0 - lr) * cent + lr * bmean, cent)
    return cent, _assign(x, cent)


def _minibatch_draws(counts: torch.Tensor, n: int, k: int, iters: int,
                     batch_size: int, generator: torch.Generator
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minibatch draws of G clusters whose real rows are the first
    ``counts`` [G] of n: k distinct seed rows [G, k] and ``iters`` batches
    [G, iters, batch_size] drawn with replacement, all uniform over the
    real rows."""
    dev = counts.device
    real = torch.arange(n, device=dev)[None] < counts[:, None]
    keys = torch.rand(len(counts), n, generator=generator, device=dev)
    seed_idx = keys.masked_fill(~real, -1.0).topk(k, dim=-1).indices
    u = torch.rand(len(counts), iters, batch_size, generator=generator,
                   device=dev)
    batch_idx = torch.minimum((u * counts[:, None, None]).long(),
                              counts[:, None, None] - 1)
    return seed_idx, batch_idx


def kmeans_fit(x: torch.Tensor, k: int, iters: int,
               generator: torch.Generator | None = None,
               init: torch.Tensor | None = None,
               mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means of x [n, d] on its device, seeded by k-means++ from
    ``generator`` unless ``init`` [k, d] is given.  ``mask`` [n] (True =
    real) leaves padded rows out of the updates.  Returns (centroids [k, d]
    f32, assignment [n])."""
    x = x.float()[None]
    w = (torch.ones(x.shape[:2], device=x.device) if mask is None
         else mask.to(x.device).float()[None])
    if init is None:
        if generator is None:
            raise ValueError("kmeans_fit needs a generator or an init")
        cent = _kmeanspp(x, w, k, generator)
    else:
        cent = init.to(x.device).float()[None]
    cent, assign = _lloyd(x, w, cent, iters)
    return cent[0], assign[0]


def kmeans_fit_minibatch(x: torch.Tensor, k: int, iters: int,
                         batch_size: int,
                         generator: torch.Generator | None = None,
                         seed_idx: torch.Tensor | None = None,
                         batch_idx: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minibatch k-means of x [n, d] on its device, seeded with k distinct
    rows.  ``seed_idx`` [k] and ``batch_idx`` [iters, batch_size] replace
    the draws from ``generator``.  Returns (centroids [k, d], assignment
    [n])."""
    x = x.float()
    if seed_idx is None or batch_idx is None:
        if generator is None:
            raise ValueError("kmeans_fit_minibatch needs a generator or "
                             "both seed_idx and batch_idx")
        drawn = _minibatch_draws(torch.tensor([x.shape[0]], device=x.device),
                                 x.shape[0], k, iters, batch_size, generator)
        seed_idx = drawn[0][0] if seed_idx is None else seed_idx
        batch_idx = drawn[1][0] if batch_idx is None else batch_idx
    seed_idx = torch.as_tensor(seed_idx, device=x.device).long()
    batch_idx = torch.as_tensor(batch_idx, device=x.device).long()
    cent, assign = _minibatch(x[None], x[seed_idx][None], batch_idx[None])
    return cent[0], assign[0]


def _real_weights(counts: torch.Tensor, n: int) -> torch.Tensor:
    return (torch.arange(n, device=counts.device)[None]
            < counts[:, None]).float()


def _fit_gather_batch(X: torch.Tensor, idx: torch.Tensor,
                      counts: torch.Tensor, k: int, iters: int,
                      generator: torch.Generator) -> torch.Tensor:
    """Lloyd fits of G clusters gathered from the device store X [N, d]:
    idx [G, b] row indices whose first ``counts`` [G] are each cluster's
    members (the rest pad).  Returns the assignments [G, b]."""
    x = X[idx]
    w = _real_weights(counts, idx.shape[1])
    return _lloyd(x, w, _kmeanspp(x, w, k, generator), iters)[1]


def _fit_gather_minibatch_batch(X: torch.Tensor, idx: torch.Tensor,
                                counts: torch.Tensor, k: int, iters: int,
                                batch_size: int, generator: torch.Generator
                                ) -> torch.Tensor:
    """Minibatch fits of G gathered clusters (as ``_fit_gather_batch``)."""
    x = X[idx]
    seed_idx, batch_idx = _minibatch_draws(counts, idx.shape[1], k, iters,
                                           batch_size, generator)
    rows = torch.arange(len(idx), device=X.device)[:, None]
    return _minibatch(x, x[rows, seed_idx], batch_idx)[1]


def _size_class(n: int, minimum: int = 64) -> int:
    """Next power of two ≥ n: clusters of one class share a batched fit,
    so a group's padding stays under 2× its rows."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _store_device(X, device: str | torch.device) -> torch.device:
    """The device a store is fitted on: a tensor's own, else ``device``
    (a missing card raises)."""
    if isinstance(X, torch.Tensor):
        return X.device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: CUDA is not available; ask for "
                           f"the CPU explicitly (device='cpu')")
    return dev


def hierarchical_kmeans(X, kary: int, leaf_cap: int, iters: int = 25,
                        seed: int = 7, max_depth: int = 8,
                        doc_level_suffix: bool = False,
                        minibatch_threshold: int = 0,
                        minibatch_size: int = 1024,
                        device: str | torch.device = "cuda"
                        ) -> list[list[int]]:
    """Per-doc CID digit paths (``paths[i]``, length ≤ max_depth) of X
    [N, d] (numpy, or a tensor, fitted on its own device; a numpy store is
    copied once to ``device``).

    A cluster is a leaf at ≤ ``leaf_cap`` docs or at ``max_depth``; one of
    ≤ ``kary`` docs enumerates them; otherwise it is split by k-means
    (minibatch at ≥ ``minibatch_threshold`` points when that is set), and a
    split that puts every point in one cluster falls back to round-robin.
    """
    n_total = X.shape[0]
    if n_total < 20_000 and not (minibatch_threshold
                                 and n_total >= minibatch_threshold):
        # the reference package's host path (its rule: no cluster could
        # take the minibatch mode), so small corpora get its paths exactly
        Xh = X.detach().cpu().numpy() if isinstance(X, torch.Tensor) else X
        return _hierarchical_numpy(np.asarray(Xh, np.float32), kary,
                                   leaf_cap, iters, seed, max_depth,
                                   doc_level_suffix)
    dev = _store_device(X, device)
    X_dev = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    paths: list[list[int]] = [[] for _ in range(n_total)]

    # rows per batched fit: ~3 GB of gathered f32 (and as much again in
    # temporaries), so wide stores do not scale the footprint
    max_rows_per_call = max(3 * (1 << 30) // (4 * int(X.shape[1])), 1 << 14)

    pending: list[tuple[np.ndarray, int]] = [(np.arange(n_total), 0)]
    while pending:
        to_fit: list[tuple[np.ndarray, int]] = []
        for idx, depth in pending:
            n = len(idx)
            if n <= leaf_cap or depth >= max_depth:
                if doc_level_suffix and n > 1:
                    for pos, doc in enumerate(idx):
                        paths[doc].append(pos)
            elif n <= kary:
                for pos, doc in enumerate(idx):       # enumerate directly
                    paths[doc].append(pos)
            else:
                to_fit.append((idx, depth))

        by_class: dict[tuple[int, bool], list[tuple[np.ndarray, int]]] = {}
        for idx, depth in to_fit:
            mb = bool(minibatch_threshold) and len(idx) >= minibatch_threshold
            by_class.setdefault((_size_class(len(idx)), mb), []).append(
                (idx, depth))

        pending = []
        for (size, mb), group in sorted(by_class.items()):
            chunk = max(1, max_rows_per_call // size)
            for s in range(0, len(group), chunk):
                part = group[s:s + chunk]
                b = max(len(idx) for idx, _ in part)
                idxs = np.zeros((len(part), b), np.int64)
                for j, (idx, _) in enumerate(part):
                    idxs[j, :len(idx)] = idx
                idx_t = torch.as_tensor(idxs, device=dev)
                counts = torch.as_tensor([len(idx) for idx, _ in part],
                                         device=dev)
                if mb:
                    assigns = _fit_gather_minibatch_batch(
                        X_dev, idx_t, counts, kary, iters,
                        min(minibatch_size, b), gen)
                else:
                    assigns = _fit_gather_batch(X_dev, idx_t, counts, kary,
                                                iters, gen)
                assigns = assigns.cpu().numpy()
                for j, (idx, depth) in enumerate(part):
                    n = len(idx)
                    assign = assigns[j, :n]
                    if len(np.unique(assign)) == 1:   # degenerate split
                        assign = np.arange(n) % kary
                    for c in range(kary):
                        members = idx[assign == c]
                        if len(members) == 0:
                            continue
                        for doc in members:
                            paths[doc].append(c)
                        pending.append((members, depth + 1))
    return paths


def _numpy_fit(x: np.ndarray, k: int, iters: int,
               rng: np.random.Generator) -> np.ndarray:
    """Host Lloyd k-means with k-means++ seeding; returns assignments [n]."""
    n, d = x.shape
    cent = np.empty((k, d), np.float32)
    cent[0] = x[rng.integers(n)]
    mind = ((x - cent[0]) ** 2).sum(1)
    for i in range(1, k):
        s = mind.sum()
        if s <= 0:                      # all remaining points identical
            cent[i] = x[rng.integers(n)]
            continue
        cent[i] = x[rng.choice(n, p=mind / s)]
        mind = np.minimum(mind, ((x - cent[i]) ** 2).sum(1))
    xsq = (x * x).sum(1)[:, None]
    a = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = xsq - 2.0 * (x @ cent.T) + (cent * cent).sum(1)[None]
        a = d2.argmin(1)
        sums = np.zeros((k, d), np.float32)
        np.add.at(sums, a, x)
        counts = np.bincount(a, minlength=k)
        nz = counts > 0
        cent[nz] = sums[nz] / counts[nz, None]
    d2 = xsq - 2.0 * (x @ cent.T) + (cent * cent).sum(1)[None]
    return d2.argmin(1)


def _hierarchical_numpy(X: np.ndarray, kary: int, leaf_cap: int, iters: int,
                        seed: int, max_depth: int, doc_level_suffix: bool
                        ) -> list[list[int]]:
    """Small-corpus path: the same recursion, all host math (see
    hierarchical_kmeans).  Deterministic per (seed, visit order)."""
    paths: list[list[int]] = [[] for _ in range(X.shape[0])]
    counter = 0
    stack: list[tuple[np.ndarray, int]] = [(np.arange(X.shape[0]), 0)]
    while stack:
        idx, depth = stack.pop()
        n = len(idx)
        if n <= leaf_cap or depth >= max_depth:
            if doc_level_suffix and n > 1:
                for pos, doc in enumerate(idx):
                    paths[doc].append(pos)
            continue
        if n <= kary:
            for pos, doc in enumerate(idx):
                paths[doc].append(pos)
            continue
        rng = np.random.default_rng((seed, counter))
        counter += 1
        assign = _numpy_fit(X[idx], kary, iters, rng)
        if len(np.unique(assign)) == 1:
            assign = np.arange(n) % kary
        for c in range(kary):
            members = idx[assign == c]
            if len(members) == 0:
                continue
            for doc in members:
                paths[doc].append(c)
            stack.append((members, depth + 1))
    return paths


def paths_to_cid_mapping(paths: list[list[int]]) -> dict[str, list[int]]:
    """Digit paths → {CID string: [doc indices]}, the input of build_trie."""
    out: dict[str, list[int]] = {}
    for doc, p in enumerate(paths):
        cid = "-".join(str(d) for d in p)
        out.setdefault(cid, []).append(doc)
    return out
