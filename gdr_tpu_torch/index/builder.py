"""Index construction: embed the corpus → hierarchical k-means → CID trie,
mirroring ``gdr_tpu/index/builder.py``.

The doc tower runs on its own device (the card unless the caller built it
on the CPU), batch after batch, and the embeddings stay there: the k-means
of ``build_index`` reads them in place, and the host gets one copy at the
end for the trie's node embeddings and the saved store.
"""

from __future__ import annotations

import numpy as np
import torch

from gdr_tpu_torch.config import IndexConfig
from gdr_tpu_torch.index.io import Index
from gdr_tpu_torch.models.dual_encoder import DocEncoder
from gdr_tpu_torch.ops.kmeans import hierarchical_kmeans, paths_to_cid_mapping
from gdr_tpu_torch.ops.trie import build_trie


@torch.no_grad()
def _embed(doc_encoder: DocEncoder, token_ids: np.ndarray,
           masks: np.ndarray, batch_size: int, normalize: bool
           ) -> torch.Tensor:
    """Doc embeddings [N, d] in f32 on the tower's device."""
    vocab = doc_encoder.cfg.vocab_size
    if len(token_ids) and (token_ids.min() < 0 or token_ids.max() >= vocab):
        raise ValueError(
            f"token ids span [{token_ids.min()}, {token_ids.max()}], outside "
            f"the doc encoder's vocab of {vocab}: size the tower to the "
            f"tokenizer")
    dev = doc_encoder.device
    chunks = [doc_encoder(
        torch.as_tensor(token_ids[s:s + batch_size], device=dev).long(),
        torch.as_tensor(masks[s:s + batch_size], device=dev)).float()
        for s in range(0, len(token_ids), batch_size)]
    out = (torch.cat(chunks) if chunks
           else torch.zeros(0, doc_encoder.cfg.d_model, device=dev))
    bad = ~torch.isfinite(out).all(dim=1)
    if bool(bad.any()):
        rows = torch.nonzero(bad)[:, 0]
        raise ValueError(
            f"doc encoder produced non-finite embeddings for {len(rows)} "
            f"docs (first: {rows[:5].tolist()}) — check that the checkpoint "
            f"weights are sane")
    if normalize:
        out = out / out.norm(dim=1, keepdim=True).clamp_min(1e-9)
    return out


def embed_corpus(doc_encoder: DocEncoder, token_ids: np.ndarray,
                 masks: np.ndarray, batch_size: int = 256,
                 normalize: bool = False, mesh=None) -> np.ndarray:
    """Doc-tower encode of the whole corpus: [N, d] f32 on the host.

    ``mesh`` (``parallel/mesh.py``; every rank calls it with the same
    corpus and tower): ``batch_size`` is rounded up to a multiple of dp,
    the last batch padded with its first row; each dp rank encodes its
    rows of each batch, and one all-gather over the dp column builds the
    whole [N, d] on every rank.  The tower's weights are whole: a train
    loop whose mp row cuts them gathers them first
    (``train/trainer.py::whole_weights``); a cut tower raises."""
    if mesh is None or mesh.dp == 1:
        return _embed(doc_encoder, token_ids, masks, batch_size,
                      normalize).cpu().numpy()
    n, dp = len(token_ids), mesh.dp
    batch_size = -(-batch_size // dp) * dp
    pad = -n % batch_size
    if pad:
        first = n - n % batch_size        # the last batch's first row
        token_ids = np.concatenate(
            [token_ids, np.repeat(token_ids[first][None], pad, 0)])
        masks = np.concatenate([masks, np.repeat(masks[first][None], pad, 0)])
    per = batch_size // dp
    mine = (np.arange(0, len(token_ids), batch_size)[:, None]
            + mesh.dp_rank * per + np.arange(per)).reshape(-1)
    local = _embed(doc_encoder, token_ids[mine], masks[mine], per, normalize)
    d = local.shape[1]
    # rank-major [dp, batches, per, d] → batch-major rows
    out = mesh.all_gather_dp(local).reshape(dp, -1, per, d).transpose(0, 1)
    return out.reshape(-1, d)[:n].cpu().numpy()


def build_index_from_embeddings(store, cfg: IndexConfig,
                                device: str | torch.device = "cuda"
                                ) -> Index:
    """k-means the embeddings [N, d] (numpy, or a tensor on its device)
    into CID paths and pack the trie."""
    if store.ndim != 2 or store.shape[1] != cfg.embedding_dim:
        raise ValueError(
            f"store shape {tuple(store.shape)} does not match "
            f"IndexConfig.embedding_dim={cfg.embedding_dim} — wrong store "
            "file, or set embedding_dim to the doc tower's output width")
    paths = hierarchical_kmeans(store, kary=cfg.kary, leaf_cap=cfg.leaf_cap,
                                iters=cfg.max_iters, seed=cfg.seed,
                                minibatch_threshold=cfg.minibatch_threshold,
                                minibatch_size=cfg.minibatch_size,
                                device=device)
    host = (store.detach().float().cpu().numpy()
            if isinstance(store, torch.Tensor) else np.asarray(store))
    trie = build_trie(paths_to_cid_mapping(paths), kary=cfg.kary,
                      max_docs_per_cluster=cfg.max_docs_per_cluster,
                      doc_embeddings=host)
    cid_of_doc = ["-".join(str(d) for d in p) for p in paths]
    return Index(store=host, trie=trie, paths=paths, cid_of_doc=cid_of_doc)


def build_index(doc_encoder: DocEncoder, token_ids: np.ndarray,
                masks: np.ndarray, cfg: IndexConfig,
                batch_size: int = 256) -> Index:
    store = _embed(doc_encoder, token_ids, masks, batch_size, False)
    return build_index_from_embeddings(store, cfg)
