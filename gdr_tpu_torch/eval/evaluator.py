"""End-to-end retrieval: beam decode → cluster expansion → dense re-rank →
metrics, mirroring ``gdr_tpu/eval/evaluator.py``.

The model holds its weights (an ``nn.Module``), so ``retrieve`` takes only
the token arrays.  Everything runs on the model's device: on a CUDA device
the decoder sublayers and the re-rank scorers run as the port's
hand-written kernels, on the CPU as their plain versions.  The store has
four layouts: plain, cluster-packed (``packed``), and each of them as
per-row int8 (``quantize``).  The per-position U candidate table of the
efficient PAWA head is built once per weight set and reused by every
retrieve.  On a CUDA device a beam decode in eval mode replays CUDA graphs
of its device work (``ops/decode_graphs.py``).

The CIDs come from beam search or, with ``gen_method`` ``sample`` /
``top_k``, from sampled rollouts whose noise comes from a generator seeded
by (``sample_seed``, batch index).  The dense-stage query is the encoder
rep, or with ``use_query_embed_decoder_avg`` / ``_special`` each beam's
pooled decoder states, averaged with the encoder rep or fused by the
``concate`` layer (``fusion_strategy``).

With ``mesh=`` (``parallel/mesh.py``) the store is row-sharded over the
mesh's ranks, one per GPU: each rank holds only its rows, decodes the
whole batch, scores the candidates it owns through its layout's scorer
and merges the ranks' winners with one ``all_gather``
(``parallel/store.py``), so every rank returns the same result.  The
sharded layouts are plain, packed and packed int8.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from gdr_tpu_torch.config import EvalConfig
from gdr_tpu_torch.eval import metrics as M
from gdr_tpu_torch.eval.offline import write_result_tsv
from gdr_tpu_torch.ops.beam import BeamResult, generate_cids, sample_cids
from gdr_tpu_torch.ops.codec import decode_token_batch
from gdr_tpu_torch.ops.decode_graphs import DecodeGraphs
from gdr_tpu_torch.ops.packed_store import (pack_layout, pack_layout_sharded,
                                            pack_rows)
from gdr_tpu_torch.ops.quantize import pack_quantized_rows, quantize_store
from gdr_tpu_torch.ops.rerank import RerankResult, rerank, rerank_packed
from gdr_tpu_torch.ops.trie import TrieTensors
from gdr_tpu_torch.parallel.store import (place_packed_store, place_store,
                                          sharded_rerank_from_beams,
                                          sharded_rerank_packed)
from gdr_tpu_torch.utils.rng import fold_in
from gdr_tpu_torch.utils.timing import PhaseTimer, span


@dataclass
class EvalData:
    """Host-side eval set: token arrays and ground-truth doc / CID strings."""

    input_ids: np.ndarray        # [Q, S]
    attn_mask: np.ndarray        # [Q, S]
    gt_docs: list[list[str]]
    gt_cids: list[list[str]]


def sample_seed(seed: int, batch_idx: int) -> int:
    """The seed of batch ``batch_idx``'s sampling generator: ``seed`` and
    the batch index mixed by numpy's SeedSequence, so that every batch
    draws other noise."""
    return fold_in(seed, batch_idx)


class Evaluator:
    """Retrieval evaluator on the device of ``model``.  ``packed``: lay the
    store out cluster-contiguously so the re-rank reads one contiguous block
    per beam (ops/packed_store.py) through the packed scorer kernel.
    ``quantize``: hold the store as per-row absmax int8 (ops/quantize.py,
    4× smaller) and score with the dequantising dot.  ``mesh``: a
    ``parallel.mesh.Mesh``; the store is then row-sharded over its ranks
    (plain, or with ``packed`` the shard-aware packed layout, int8 with
    ``quantize``) and the re-rank merges across them."""

    def __init__(self, model, trie: TrieTensors, store, cfg: EvalConfig,
                 mesh=None, packed: bool = False, quantize: bool = False):
        if quantize and mesh is not None and not packed:
            raise ValueError("quantize=True with a mesh needs packed=True "
                             "(the shard-aware int8 layout; the plain "
                             "sharded re-rank has no quantized variant)")
        self.model = model
        self.trie = trie
        self.cfg = cfg
        self.mesh = mesh
        self.packed = packed
        self.quantize = quantize
        dev = model.device
        self.device = dev
        if packed:
            # the reference's int8 layout aligns blocks to 32 rows (a TPU
            # int8 tiling rule); kept so that starts equal the reference's
            align = 32 if quantize else 8
            if mesh is not None:
                starts, counts, row_to_doc, cap, self._p_shard_rows = \
                    pack_layout_sharded(trie, mesh.size, align=align)
            else:
                starts, counts, row_to_doc, cap = pack_layout(trie,
                                                              align=align)
            self._p_row_to_doc_host = row_to_doc
            self._p_starts = torch.as_tensor(starts, device=dev)
            self._p_counts = torch.as_tensor(counts, device=dev)
            self._p_row_to_doc = torch.as_tensor(row_to_doc, device=dev)
            self._p_cap = cap
        self.set_store(store)
        # every root-to-cluster path ends by the trie's max depth, so the
        # decode needs at most depth+1 steps (digits + EOS); pooled decoder
        # reps need one more, so that full-depth beams' EOS input enters
        # the pool
        self._want_dec = (cfg.use_query_embed_decoder_avg
                          or cfg.use_query_embed_decoder_special)
        self._max_len = min(cfg.max_output_length,
                            int(trie.depth.max()) + 1 + int(self._want_dec))
        if (self._want_dec and cfg.use_query_embed_encoder
                and cfg.fusion_strategy == "concate"
                and not model.cfg.concate_fusion):
            raise ValueError("fusion_strategy 'concate' needs a model with "
                             "the fusion layer (ModelConfig.concate_fusion)")
        self._children = torch.as_tensor(trie.children, device=dev)
        self._eos = torch.as_tensor(trie.eos_allowed, device=dev)
        self._cluster_of_node = torch.as_tensor(trie.cluster_of_node,
                                                device=dev)
        self._cluster_docs = torch.as_tensor(trie.cluster_docs, device=dev)
        self._cluster_doc_mask = torch.as_tensor(trie.cluster_doc_mask,
                                                 device=dev)
        self._alphas = torch.as_tensor(np.asarray(cfg.score_rates, np.float32),
                                       device=dev)
        self._ut_key = None
        self._ut = None
        self._graphs = DecodeGraphs()

    def set_store(self, store) -> None:
        """Replace the doc-embedding store [N, d], applying this evaluator's
        layout (cluster packing, int8 quantization) on the model's device.
        On a mesh only this rank's rows reach the device: a numpy store
        (a memory map too) is read only at those rows."""
        if self.mesh is not None:
            self.store = (place_packed_store(store, self._p_row_to_doc_host,
                                             self.mesh, self.device,
                                             quantize=self.quantize)
                          if self.packed else
                          place_store(store, self.mesh, self.device))
            return
        store = torch.as_tensor(store).to(self.device)
        if self.packed and self.quantize:
            self.store = pack_quantized_rows(store, self._p_row_to_doc)
        elif self.packed:
            self.store = pack_rows(store, self._p_row_to_doc)
        elif self.quantize:
            self.store = quantize_store(store)
        else:
            self.store = store

    def _u_table(self):
        """Per-position U candidate slices of the efficient PAWA head, built
        once per weight set: keyed on the U parameter's storage and version
        counter, so an in-place update or a new tensor rebuilds it."""
        c = self.model.cfg
        if not (c.adaptor_decode and c.adaptor_efficient):
            return None
        u = self.model.pawa.u
        key = (u.data_ptr(), u._version, u.dtype, u.device)
        if self._ut_key != key:
            with torch.no_grad():
                self._ut = self.model.decode_tables(self._max_len)
            self._ut_key = key
        return self._ut

    @torch.no_grad()
    def retrieve(self, input_ids, attn_mask, batch_idx: int = 0,
                 noise: torch.Tensor | None = None
                 ) -> tuple[BeamResult, RerankResult]:
        """Single-batch retrieval: token arrays [B, S] → (BeamResult,
        RerankResult) on the model's device.  Sampled decoding draws its
        noise from a generator seeded by (``sample_seed``, ``batch_idx``),
        so eval batches get different noise; ``noise`` [max_len,
        B·num_beams, kary+1] replaces those draws (the same noise on two
        devices gives the same rollouts)."""
        with span("gdr.retrieve", f"rows={len(input_ids)}"):
            cfg = self.cfg
            model = self.model
            ids = torch.as_tensor(np.asarray(input_ids), device=self.device)
            msk = torch.as_tensor(np.asarray(attn_mask), device=self.device)
            if cfg.gen_method in ("sample", "top_k"):
                gen = None
                if noise is None:
                    gen = torch.Generator(device=self.device).manual_seed(
                        sample_seed(cfg.sample_seed, batch_idx))
                res, q_emb, _ = sample_cids(
                    model, ids, msk, self._children, self._eos, cfg.num_beams,
                    self._max_len, gen, temperature=cfg.temperature,
                    top_k=cfg.sample_top_k, length_penalty=cfg.length_penalty,
                    accumulate_hidden=self._want_dec, u_table=self._u_table,
                    noise=noise)
            else:   # "beam"; the reference's "greedy" is beam search too
                res, q_emb, _ = generate_cids(
                    model, ids, msk, self._children, self._eos, cfg.num_beams,
                    self._max_len, cfg.length_penalty, u_table=self._u_table,
                    accumulate_hidden=self._want_dec, graphs=self._graphs)
            if self._want_dec:
                with span("gdr.query"):
                    pooled = (res.hid_last
                              if cfg.use_query_embed_decoder_special
                              else res.hid_avg)
                    q_dec = model.project_query(pooled)           # [B, K, d']
                    res = replace(res, hid_avg=None, hid_last=None)
                    if not cfg.use_query_embed_encoder:
                        q_emb = q_dec
                    elif cfg.fusion_strategy == "concate":
                        q_emb = model.fuse_queries(q_dec, q_emb[:, None, :])
                    else:                                         # "average"
                        q_emb = (q_dec + q_emb[:, None, :]) / 2.0
            return res, self.rerank(q_emb, res)

    @torch.no_grad()
    def rerank(self, q_emb, res: BeamResult) -> RerankResult:
        """Stage 2 of ``retrieve`` on this evaluator's store layout: the
        beams' clusters expanded, scored against ``q_emb`` and fused."""
        top_r = self.cfg.num_return_sequences
        with span("gdr.rerank"):
            if self.mesh is not None and self.packed:
                return sharded_rerank_packed(
                    self.mesh, self.store, self._p_starts, self._p_counts,
                    self._p_row_to_doc, self._p_cap, self._p_shard_rows, q_emb,
                    res.nodes, res.scores, res.valid, self._cluster_of_node,
                    self._alphas, top_r=top_r)
            if self.mesh is not None:
                return sharded_rerank_from_beams(
                    self.mesh, self.store, q_emb, res.nodes, res.scores,
                    res.valid, self._cluster_of_node, self._cluster_docs,
                    self._cluster_doc_mask, self._alphas, top_r=top_r)
            if self.packed:
                return rerank_packed(
                    self.store, self._p_starts, self._p_counts,
                    self._p_row_to_doc, self._p_cap, q_emb, res.nodes,
                    res.scores, res.valid, self._cluster_of_node,
                    self._alphas, top_r=top_r)
            return rerank(self.store, q_emb, res.nodes, res.scores, res.valid,
                          self._cluster_of_node, self._cluster_docs,
                          self._cluster_doc_mask, self._alphas, top_r=top_r)

    def retrieve_many(self, input_ids, attn_mask
                      ) -> tuple[BeamResult, RerankResult]:
        """Retrieval of G batches: token arrays [G, B, S] → (BeamResult,
        RerankResult) whose fields carry a leading G axis.  The reference
        maps the batches inside one compiled program; here it is a loop of
        ``retrieve`` on the model's device, stacked.  Sub-batch ``g`` is
        batch index ``g`` of sampled decoding."""
        ids, msk = np.asarray(input_ids), np.asarray(attn_mask)
        outs = [self.retrieve(ids[g], msk[g], batch_idx=g)
                for g in range(len(ids))]

        def stack(cls, parts):        # fields that are None stay None
            return cls(**{f.name: None if getattr(parts[0], f.name) is None
                          else torch.stack([getattr(p, f.name) for p in parts])
                          for f in fields(cls)})
        return (stack(BeamResult, [o[0] for o in outs]),
                stack(RerankResult, [o[1] for o in outs]))

    def evaluate(self, data: EvalData, batch_size: int = 8,
                 kary: int | None = None,
                 result_tsv: str | None = None) -> dict[str, float]:
        """Full-set evaluation: cluster-level metrics over the generated
        CIDs, doc-level metrics per fusion weight α, and the wall time of
        the ``retrieve`` and ``decode_host`` phases (``*_total_s``,
        ``*_mean_ms``).  ``result_tsv``: also write the reference-compatible
        result file (query, preds at the first α, gts, rank) that the
        ``calculate`` subcommand reads."""
        kary = kary or self.trie.kary
        nq = len(data.input_ids)
        cluster_preds: dict[int, list[str]] = {}
        doc_preds: dict[int, dict[float, list[str]]] = {}
        timer = PhaseTimer()
        for start in range(0, nq, batch_size):
            end = min(start + batch_size, nq)
            pad = batch_size - (end - start)
            ids = np.concatenate(
                [data.input_ids[start:end]]
                + ([data.input_ids[start:start + 1]] * pad if pad else []))
            msk = np.concatenate(
                [data.attn_mask[start:end]]
                + ([data.attn_mask[start:start + 1]] * pad if pad else []))
            with timer.phase("retrieve"):
                res, rr = self.retrieve(ids, msk,
                                        batch_idx=start // batch_size)
                seqs = res.sequences.cpu().numpy()
                valid = res.valid.cpu().numpy()
                doc_ids = rr.doc_ids.cpu().numpy()
                doc_valid = rr.doc_valid.cpu().numpy()
            with timer.phase("decode_host"):
                nb, k = end - start, seqs.shape[1]
                cids_flat = decode_token_batch(seqs[:nb].reshape(nb * k, -1),
                                               kary)
                doc_str = doc_ids[:, :nb].astype(str)
                for b in range(nb):
                    q = start + b
                    cluster_preds[q] = [cids_flat[b * k + j]
                                        for j in np.flatnonzero(valid[b])]
                    doc_preds[q] = {
                        alpha: doc_str[a, b][doc_valid[a, b]].tolist()
                        for a, alpha in enumerate(self.cfg.score_rates)}

        if result_tsv is not None:
            alpha0 = self.cfg.score_rates[0]
            write_result_tsv(result_tsv, [
                (str(q), doc_preds[q][alpha0], data.gt_docs[q], 1)
                for q in sorted(doc_preds)])

        out: dict[str, float] = {}
        gt_cids = {q: data.gt_cids[q] for q in cluster_preds}
        out.update(M.full_suite(cluster_preds, gt_cids,
                                recall_ks=self.cfg.recall_ks,
                                accuracy_ks=self.cfg.accuracy_ks,
                                mrr_ks=self.cfg.mrr_ks,
                                map_k=self.cfg.map_k, prefix="cluster_"))
        gt_docs = {q: data.gt_docs[q] for q in cluster_preds}
        for alpha in self.cfg.score_rates:
            preds_a = {q: doc_preds[q][alpha] for q in doc_preds}
            suite = M.full_suite(preds_a, gt_docs,
                                 recall_ks=self.cfg.recall_ks,
                                 accuracy_ks=self.cfg.accuracy_ks,
                                 mrr_ks=self.cfg.mrr_ks, map_k=self.cfg.map_k)
            for k, v in suite.items():
                out[f"{k}_{alpha}"] = v
            if alpha == 0:
                out["recall1"] = suite["recall1"]
        out.update(timer.summary())
        return out
