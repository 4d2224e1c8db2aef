"""Secondary training and eval modes — the N-decoder ensemble, the
per-depth hierarchic decoders and the softmax classifier — mirroring
``gdr_tpu/train/modes.py`` (the CLI's ``train --ensemble N`` /
``--hierarchic`` / ``--softmax`` and ``eval --ensemble N``).

Each mode trains in f32 on the given device with ``train/optimizer.py::
AdamW``, as the reference's optax transformations: the ensemble's four
groups (encoder / decoder side × decay / no decay, the decoder side at
``decoder_lr``, a global-norm clip first), the hierarchic and softmax modes'
one group.  The reference builds every group that it means not to decay
with ``optax.adamw(lr)``, whose default weight decay is 1e-4, so those
groups decay at 1e-4 here too.

State files (the reference's flax msgpack cannot be read without flax):
``ensemble.npz`` + ``ensemble_paths.npy``, ``hierarchic.npz`` and
``softmax.npz`` in the workdir, the reference's trees as ``.npz`` of
``/``-joined paths (``convert.py``).

On a CUDA device the ensemble's eval runs the three decoder-sublayer
kernels and the ``rerank_scores`` scorer (``Evaluator``, one per member),
and the hierarchic eval runs the scorer after its plain-PyTorch decode.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gdr_tpu_torch.config import EvalConfig, ModelConfig
from gdr_tpu_torch.convert import (ensemble_from_flax, ensemble_to_flax,
                                   hierarchic_to_flax, load_tree_npz,
                                   params_to_flax, save_tree_npz)
from gdr_tpu_torch.data.dataset import TrainSet
from gdr_tpu_torch.eval import metrics as M
from gdr_tpu_torch.eval.evaluator import EvalData
from gdr_tpu_torch.index.io import Index
from gdr_tpu_torch.train.optimizer import OPTAX_ADAMW_WD, AdamW, _is_no_decay
from gdr_tpu_torch.utils.rng import generator


def _batches(n: int, batch_size: int, seed: int):
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    end = n - n % batch_size
    for s in range(0, end, batch_size):
        yield order[s:s + batch_size]


def _padded(arr: np.ndarray, s: int, e: int, bs: int) -> np.ndarray:
    """Rows s..e of ``arr``, padded to ``bs`` rows with row s."""
    pad = bs - (e - s)
    return np.concatenate([arr[s:e]] + ([arr[s:s + 1]] * pad if pad else []))


# --------------------------------------------------------------- ensemble

def alternative_assignments(index: Index, num: int, kary: int,
                            leaf_cap: int, seed: int, device="cuda"
                            ) -> list[list[list[int]]]:
    """N docid assignments over one corpus: the index's own and ``num-1``
    re-runs of hierarchical k-means (seeds ``seed + 1009·i``) on
    ``device``."""
    from gdr_tpu_torch.ops.kmeans import hierarchical_kmeans
    out = [index.paths]
    for i in range(1, num):
        out.append(hierarchical_kmeans(index.store, kary=kary,
                                       leaf_cap=leaf_cap, iters=15,
                                       seed=seed + 1009 * i, device=device))
    return out


def _member_labels(paths_list, pos_idx, mcfg: ModelConfig) -> np.ndarray:
    from gdr_tpu_torch.ops.codec import digits_to_label
    n, q, L = len(paths_list), len(pos_idx), mcfg.max_output_length
    labels = np.zeros((n, q, L), np.int32)
    for i, paths in enumerate(paths_list):
        for j, doc in enumerate(pos_idx):
            labels[i, j], _ = digits_to_label(paths[int(doc)], mcfg.kary, L,
                                              mcfg.position)
    return labels


def paths_to_array(paths_list) -> np.ndarray:
    depth = max((len(p) for paths in paths_list for p in paths), default=1)
    arr = np.full((len(paths_list), len(paths_list[0]), depth), -1, np.int32)
    for i, paths in enumerate(paths_list):
        for j, p in enumerate(paths):
            arr[i, j, :len(p)] = p
    return arr


def array_to_paths(arr: np.ndarray) -> list[list[list[int]]]:
    return [[[int(d) for d in row if d >= 0] for row in member]
            for member in arr]


def ensemble_optimizer(ens, lr: float, decoder_lr: float) -> AdamW:
    """The reference's ``chain(clip_by_global_norm(1.0),
    multi_transform)`` over enc_wd / enc_nd / dec_wd / dec_nd: the wd
    groups decay at its 1e-4, and the nd groups are ``optax.adamw(lr)``,
    so they decay at optax's default, also 1e-4."""
    labels = {name: f"{ens.side_of(name)}_"
                    f"{'nd' if _is_no_decay(name, p) else 'wd'}"
              for name, p in ens.named_parameters()}
    hyper = {"enc_wd": (lr, 1e-4), "enc_nd": (lr, OPTAX_ADAMW_WD),
             "dec_wd": (decoder_lr, 1e-4),
             "dec_nd": (decoder_lr, OPTAX_ADAMW_WD)}
    return AdamW(ens, hyper, labels, max_grad_norm=1.0)


def train_ensemble(mcfg: ModelConfig, index: Index, train_set: TrainSet,
                   num_decoders: int, epochs: int, lr: float,
                   batch_size: int, workdir: str, seed: int,
                   leaf_cap: int = 30, decoder_lr: float | None = None,
                   rdrop: float = 0.0, rdrop_loss: str = "Contrast",
                   device="cuda") -> dict:
    """Train N decoders (one per docid assignment) on one shared encoder;
    writes ``ensemble.npz`` and ``ensemble_paths.npy`` to ``workdir``.
    Step ``t`` draws its dropout from a generator seeded by (seed + 7,
    t)."""
    from gdr_tpu_torch.models.ensemble import (init_ensemble,
                                               make_ensemble_train_step)

    dev = torch.device(device)
    ens = init_ensemble(mcfg, num_decoders,
                        torch.Generator(device=dev).manual_seed(seed))
    paths_list = alternative_assignments(index, num_decoders, mcfg.kary,
                                         leaf_cap, seed, dev)
    labels = _member_labels(paths_list, train_set.pos_idx, mcfg)
    lmask = (labels != 0).astype(np.int32)
    if decoder_lr is None:
        decoder_lr = lr / 2            # the reference's default ratio
    opt = ensemble_optimizer(ens, lr, decoder_lr)
    step = make_ensemble_train_step(ens, opt, rdrop=rdrop,
                                    rdrop_loss=rdrop_loss)
    loss = float("nan")
    global_step = 0
    for epoch in range(epochs):
        losses = []
        for idx in _batches(len(train_set), batch_size, seed + epoch):
            batch = {"input_ids": train_set.input_ids[idx],
                     "attn_mask": train_set.attn_mask[idx],
                     "labels": labels[:, idx], "label_mask": lmask[:, idx]}
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            loss, _ = step(batch, generator(seed + 7, global_step, dev))
            loss = float(loss)
            losses.append(loss)
            global_step += 1
        print(f"ensemble epoch {epoch}: loss {np.mean(losses):.4f}")

    os.makedirs(workdir, exist_ok=True)
    save_tree_npz(os.path.join(workdir, "ensemble.npz"), ensemble_to_flax(ens))
    np.save(os.path.join(workdir, "ensemble_paths.npy"),
            paths_to_array(paths_list))
    return {"model": ens, "paths_list": paths_list, "final_loss": loss}


def load_ensemble(mcfg: ModelConfig, workdir: str, num_decoders: int,
                  device="cuda"):
    """The ensemble of ``<workdir>/ensemble.npz`` on ``device``."""
    from gdr_tpu_torch.models.ensemble import Ensemble

    sd = ensemble_from_flax(load_tree_npz(
        os.path.join(workdir, "ensemble.npz")))
    ens = Ensemble(mcfg, num_decoders)
    ens.load_state_dict(sd)
    return ens.to(device)


def eval_ensemble(mcfg: ModelConfig, index: Index, dev: EvalData,
                  workdir: str, num_decoders: int, beam: int,
                  batch_size: int = 8, score_rates=(0.0,), device="cuda",
                  ens=None) -> dict[str, float]:
    """Per-member constrained retrieval over each member's own trie (from
    ``ensemble_paths.npy``) and the plain store, merged by best fused
    score.  ``ens``: the ensemble, else ``<workdir>/ensemble.npz``."""
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models.ensemble import merge_retrievals
    from gdr_tpu_torch.ops.kmeans import paths_to_cid_mapping
    from gdr_tpu_torch.ops.trie import build_trie

    if ens is None:
        ens = load_ensemble(mcfg, workdir, num_decoders, device)
    paths_list = array_to_paths(
        np.load(os.path.join(workdir, "ensemble_paths.npy")))
    ev_cfg = EvalConfig(num_beams=beam, num_return_sequences=beam,
                        max_output_length=mcfg.max_output_length,
                        score_rates=tuple(score_rates))
    nq = len(dev.input_ids)
    doc_lists, score_lists = [], []
    for i in range(num_decoders):
        mapping = paths_to_cid_mapping(paths_list[i])
        counts = [len(v) for v in mapping.values()]
        trie = build_trie(mapping, kary=mcfg.kary,
                          max_docs_per_cluster=max(counts + [8]),
                          doc_embeddings=index.store)
        ev = Evaluator(ens.members[i], trie, index.store, ev_cfg)
        docs_q: list[list[str]] = [[] for _ in range(nq)]
        scores_q: list[list[float]] = [[] for _ in range(nq)]
        for s in range(0, nq, batch_size):
            e = min(s + batch_size, nq)
            _, rr = ev.retrieve(_padded(dev.input_ids, s, e, batch_size),
                                _padded(dev.attn_mask, s, e, batch_size))
            d = rr.doc_ids[0].cpu().numpy()
            v = rr.doc_valid[0].cpu().numpy()
            sc = rr.scores[0].cpu().numpy()
            for b in range(e - s):
                docs_q[s + b] = [str(int(x)) for x, ok in zip(d[b], v[b])
                                 if ok]
                scores_q[s + b] = [float(x) for x, ok in zip(sc[b], v[b])
                                   if ok]
        doc_lists.append(docs_q)
        score_lists.append(scores_q)

    merged = {q: merge_retrievals([doc_lists[i][q]
                                   for i in range(num_decoders)],
                                  [score_lists[i][q]
                                   for i in range(num_decoders)],
                                  top_k=beam)
              for q in range(nq)}
    gts = {q: dev.gt_docs[q] for q in merged}
    return M.full_suite(merged, gts, recall_ks=(1, 5, 10, 20, 50, 100),
                        accuracy_ks=(1, 20, 100), mrr_ks=(10, 100),
                        map_k=100)


# -------------------------------------------------------------- hierarchic

def _cluster_and_doc_metrics(preds, doc_preds, dev: EvalData, beam: int):
    ks = tuple(k for k in (1, 5, 10, 20, 50, 100) if k <= beam) or (1,)
    aks = tuple(k for k in (1, 20, 100) if k <= beam) or (1,)
    out = M.full_suite(preds, {q: dev.gt_cids[q] for q in preds},
                       recall_ks=ks, accuracy_ks=aks, mrr_ks=(10,), map_k=10,
                       prefix="cluster_")
    out.update(M.full_suite(doc_preds, {q: dev.gt_docs[q] for q in doc_preds},
                            recall_ks=ks, accuracy_ks=aks, mrr_ks=(10,),
                            map_k=10))
    return out


def hierarchic_train_step(h, opt: AdamW, batch: dict) -> torch.Tensor:
    """One deterministic CE step on the depth-routed logits (the reference
    runs this mode without dropout).  Batch: ``input_ids`` / ``attn_mask``
    [B, S], ``labels`` / ``label_mask`` [B, L] on the model's device."""
    from gdr_tpu_torch.models.hierarchic import hierarchic_logits
    from gdr_tpu_torch.ops.losses import masked_cross_entropy

    logits = hierarchic_logits(h, batch["input_ids"], batch["attn_mask"],
                               batch["labels"], batch["label_mask"])
    loss = masked_cross_entropy(logits, batch["labels"], batch["label_mask"])
    loss.backward()
    opt.step()
    return loss.detach()


def train_eval_hierarchic(mcfg: ModelConfig, index: Index,
                          train_set: TrainSet, dev: EvalData, epochs: int,
                          lr: float, batch_size: int, workdir: str,
                          seed: int, eval_batch_size: int = 8,
                          beam: int = 10, score_rates=(0.0,),
                          length_penalty: float = 0.8,
                          device="cuda") -> dict:
    """Per-depth decoder stacks: CE on the depth-routed logits (AdamW at
    optax's defaults, weight decay 1e-4 on every parameter), then
    trie-constrained beam decode + dense re-rank.  Writes
    ``hierarchic.npz``.  ``beam=1`` is the reference's greedy mode."""
    from gdr_tpu_torch.models.hierarchic import (hierarchic_generate_cids,
                                                 init_hierarchic)
    from gdr_tpu_torch.ops.rerank import rerank

    dvc = torch.device(device)
    trie = index.trie
    h = init_hierarchic(mcfg, int(trie.depth.max()),
                        torch.Generator(device=dvc).manual_seed(seed))
    opt = AdamW(h, {"all": (lr, OPTAX_ADAMW_WD)})
    losses: list[float] = []
    for epoch in range(epochs):
        losses = []
        for idx in _batches(len(train_set), batch_size, seed + epoch):
            batch = {k: torch.as_tensor(getattr(train_set, k)[idx],
                                        device=dvc)
                     for k in ("input_ids", "attn_mask", "labels",
                               "label_mask")}
            losses.append(float(hierarchic_train_step(h, opt, batch)))
        print(f"hierarchic epoch {epoch}: loss {np.mean(losses):.4f}")
    os.makedirs(workdir, exist_ok=True)
    save_tree_npz(os.path.join(workdir, "hierarchic.npz"),
                  hierarchic_to_flax(h))

    children = torch.as_tensor(trie.children, device=dvc)
    eos_allowed = torch.as_tensor(trie.eos_allowed, device=dvc)
    tables = [torch.as_tensor(t, device=dvc) for t in (
        trie.cluster_of_node, trie.cluster_docs, trie.cluster_doc_mask)]
    store = torch.as_tensor(index.store, device=dvc)
    alphas = torch.as_tensor(np.asarray(score_rates, np.float32), device=dvc)
    nq = len(dev.input_ids)
    preds: dict[int, list[str]] = {}
    doc_preds: dict[int, list[str]] = {}
    bs = eval_batch_size
    for s in range(0, nq, bs):
        e = min(s + bs, nq)
        ids = torch.as_tensor(_padded(dev.input_ids, s, e, bs), device=dvc)
        msk = torch.as_tensor(_padded(dev.attn_mask, s, e, bs), device=dvc)
        res, q_emb = hierarchic_generate_cids(
            h, ids, msk, children, eos_allowed, num_beams=beam,
            max_len=mcfg.max_output_length, length_penalty=length_penalty)
        rr = rerank(store, q_emb, res.nodes, res.scores, res.valid, *tables,
                    alphas, top_r=beam)
        nodes = res.nodes.cpu().numpy()
        valid = res.valid.cpu().numpy()
        docs = rr.doc_ids[0].cpu().numpy()          # α = score_rates[0]
        dvalid = rr.doc_valid[0].cpu().numpy()
        for b in range(e - s):
            preds[s + b] = [trie.cid_of_node(int(n)) for n, ok
                            in zip(nodes[b], valid[b]) if ok]
            doc_preds[s + b] = [str(int(d)) for d, ok
                                in zip(docs[b], dvalid[b]) if ok]
    out = _cluster_and_doc_metrics(preds, doc_preds, dev, beam)
    out["final_loss"] = float(np.mean(losses)) if losses else float("nan")
    return out


# ---------------------------------------------------------------- softmax

def softmax_train_step(model, opt: AdamW, input_ids, attn_mask, targets,
                       generator: torch.Generator) -> torch.Tensor:
    """One classifier step: CE of the targets with dropout drawn from
    ``generator``, then one update of ``opt``."""
    from gdr_tpu_torch.models.t5 import set_dropout_generator

    model.train()
    set_dropout_generator(model, generator)
    try:
        logp = torch.log_softmax(model(input_ids, attn_mask), dim=-1)
        loss = -logp.gather(1, targets.long()[:, None]).mean()
        loss.backward()
    finally:
        model.eval()
        set_dropout_generator(model, None)
    opt.step()
    return loss.detach()


def train_eval_softmax(mcfg: ModelConfig, index: Index, train_set: TrainSet,
                       dev: EvalData, epochs: int, lr: float,
                       batch_size: int, workdir: str, seed: int,
                       eval_batch_size: int = 8,
                       device="cuda") -> dict[str, float]:
    """Softmax classification: the encoder and a linear head over the
    trie's clusters, CE with dropout (batch ``i`` of epoch ``e`` draws from
    a generator seeded ``e·7919 + i``), AdamW at optax's defaults; the
    ranking is the top ``min(100, C)`` clusters by logit.  Writes
    ``softmax.npz``."""
    from gdr_tpu_torch.models.classifier import EncoderClassifier
    from gdr_tpu_torch.models.t5 import init_t5_weights

    dvc = torch.device(device)
    trie = index.trie
    num_cls = trie.num_clusters
    node_to_row = {int(n): r for r, n in enumerate(trie.cluster_node_ids)}
    cls_of_doc = np.asarray([node_to_row[trie.node_of_path(p)]
                             for p in index.paths], np.int64)
    cid_of_row = [trie.cid_of_node(int(n)) for n in trie.cluster_node_ids]

    with torch.device(dvc):
        model = EncoderClassifier(mcfg, num_cls)
    init_t5_weights(model, torch.Generator(device=dvc).manual_seed(seed))
    opt = AdamW(model, {"all": (lr, OPTAX_ADAMW_WD)})
    targets = cls_of_doc[train_set.pos_idx]
    losses: list[float] = []
    for epoch in range(epochs):
        losses = []
        for i, idx in enumerate(_batches(len(train_set), batch_size,
                                         seed + epoch)):
            loss = softmax_train_step(
                model, opt,
                torch.as_tensor(train_set.input_ids[idx], device=dvc),
                torch.as_tensor(train_set.attn_mask[idx], device=dvc),
                torch.as_tensor(targets[idx], device=dvc),
                torch.Generator(device=dvc).manual_seed(epoch * 7919 + i))
            losses.append(float(loss))
        print(f"softmax epoch {epoch}: loss {np.mean(losses):.4f}")
    os.makedirs(workdir, exist_ok=True)
    save_tree_npz(os.path.join(workdir, "softmax.npz"),
                  params_to_flax(model.state_dict()))

    preds = rank_clusters(model, dev, cid_of_row, eval_batch_size)
    out = M.full_suite(preds, {q: dev.gt_cids[q] for q in preds},
                       recall_ks=(1, 5, 10, 20, 50, 100),
                       accuracy_ks=(1, 20, 100), mrr_ks=(10, 100),
                       map_k=100, prefix="cluster_")
    out["final_loss"] = float(np.mean(losses)) if losses else float("nan")
    return out


@torch.no_grad()
def rank_clusters(model, dev: EvalData, cid_of_row: list[str],
                  batch_size: int = 8) -> dict[int, list[str]]:
    """Each dev query's top ``min(100, C)`` clusters by the classifier's
    logit."""
    k = min(100, model.num_cls)
    d = model.fc.weight.device
    preds: dict[int, list[str]] = {}
    nq = len(dev.input_ids)
    for s in range(0, nq, batch_size):
        e = min(s + batch_size, nq)
        logits = model(
            torch.as_tensor(_padded(dev.input_ids, s, e, batch_size),
                            device=d),
            torch.as_tensor(_padded(dev.attn_mask, s, e, batch_size),
                            device=d))
        top = torch.topk(logits, k, dim=-1).indices.cpu().numpy()
        for b in range(e - s):
            preds[s + b] = [cid_of_row[int(c)] for c in top[b]]
    return preds

