"""Epoch-driven training, mirroring ``gdr_tpu/train/loop.py`` on one device
(the card unless the caller asks for the CPU).

Per epoch: shuffled batches (``BatchIterator`` seeded by the epoch), one
train step each, then the dev set's metrics (``Evaluator.evaluate`` on the
model being trained: on the card the decoder sublayer and re-rank kernels
run), a best-k checkpoint by
``monitor``, and a latest-1 resume point at every epoch's end.  Stage 1
trains against the store's doc embeddings; from epoch
``train_encoder_epoch + 1`` stage 2 trains the doc tower live (when the
corpus tokens are given), at ``stage2_train_batch_size``, and re-embeds the
corpus (or a rotating fraction of it) into the store before each eval.

A new loop resumes from the newest checkpoint: after a completed epoch it
continues with the next one; after a mid-epoch preemption it runs that
epoch again from its first batch.  ``run(deadline=)`` stops at the first
epoch boundary past a wall-clock deadline.  There is no ``eval_pallas``:
the device decides which kernels run.

``mesh`` (``parallel/mesh.py``, one process per GPU) trains over a dp × mp
mesh, as ``gdr_tpu``'s SPMD loop does: every rank builds the same global
batch and the step keeps its dp rows (``train/trainer.py``); over mp > 1
the step is column-parallel, each rank holding and computing only its
part of every large leaf (masters, moments and compute copy); the doc
store is row-sharded over the whole mesh for the step and for the
evaluator (``Evaluator(mesh=)``, each rank's layout scorer on its rows).
The eval and the store's re-embedding run on whole weights, gathered over
each mp row for them and freed after.  The loss metric is the global
batch's.  Rank 0 alone writes the metrics and the checkpoints, as full
tensors (a mesh checkpoint resumes in one process and the reverse); the
other ranks wait at a barrier, and a restore cuts again.  A preemption
stop is agreed by every rank.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from gdr_tpu_torch.config import GDRConfig
from gdr_tpu_torch.data.dataset import (BatchIterator, TrainSet,
                                        cluster_docs_lookup, doc_label_arrays)
from gdr_tpu_torch.eval.evaluator import EvalData, Evaluator
from gdr_tpu_torch.index.builder import embed_corpus
from gdr_tpu_torch.index.io import Index
from gdr_tpu_torch.models.dual_encoder import (DocEncoder, DocEncoderConfig,
                                               init_doc_encoder)
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.ops.trie import prefix_node_embeddings
from gdr_tpu_torch.parallel.mesh import tp_param_rules
from gdr_tpu_torch.parallel.store import place_store
from gdr_tpu_torch.train.checkpoint import CheckpointManager
from gdr_tpu_torch.train.trainer import (TrainState, init_train_state,
                                         load_masters, make_train_step,
                                         shard_state, unshard_state,
                                         whole_weights)
from gdr_tpu_torch.utils.logging import MetricLogger, NullLogger
from gdr_tpu_torch.utils.preemption import PreemptionGuard
from gdr_tpu_torch.utils.rng import fold_in, generator, set_seed


class TrainLoop:
    def __init__(self, cfg: GDRConfig, index: Index, train_set: TrainSet,
                 dev: EvalData, workdir: str, seed: int = 42,
                 doc_tokens: Optional[np.ndarray] = None,
                 doc_tok_mask: Optional[np.ndarray] = None,
                 doc_encoder: Optional[DocEncoder] = None,
                 mesh=None, packed_eval: bool = False,
                 warm_start: Optional[Callable] = None, device="cuda"):
        """``doc_encoder``: the stage-2 tower with its initial weights
        (default: a seeded ``DocEncoderConfig(d_model=encoder_d_model)``
        tower when ``doc_tokens`` are given).  ``warm_start(model,
        doc_encoder)`` loads pretrained weights into the f32 models before
        the masters are taken; a checkpoint to resume from overrides it.
        ``packed_eval``: the evaluator reads the cluster-packed store.
        ``mesh``: a ``parallel.mesh.Mesh`` to train over (every rank
        constructs the loop with the same arguments); both stages' batch
        sizes must divide by its dp."""
        cfg.model.refuse_experts("TrainLoop")
        if mesh is not None:
            for name, b in (("train_batch_size", cfg.train.train_batch_size),
                            ("stage2_train_batch_size",
                             cfg.train.stage2_train_batch_size)):
                if b % mesh.dp != 0:
                    raise ValueError(
                        f"TrainConfig.{name}={b} must be divisible by the "
                        f"mesh dp axis ({mesh.dp}) so every device gets "
                        f"equal batch shards")
        self.mesh = mesh
        self.cfg = cfg
        self.index = index
        self.train_set = train_set
        self.dev = dev
        self.workdir = workdir
        self.doc_tokens = doc_tokens
        self.doc_tok_mask = doc_tok_mask
        self.device = torch.device(device)
        self.seed = seed
        set_seed(seed)

        with torch.device(self.device):
            self.model = GenerativeRetriever(cfg.model)
        init_weights(self.model, generator(seed, 0, self.device))
        if doc_tokens is not None and doc_encoder is None:
            with torch.device(self.device):
                doc_encoder = DocEncoder(DocEncoderConfig(
                    d_model=cfg.model.encoder_d_model))
            init_doc_encoder(doc_encoder, generator(seed, 1, self.device))
        self.doc_encoder = (doc_encoder.to(self.device)
                            if doc_encoder is not None else None)
        if warm_start is not None:
            warm_start(self.model, self.doc_encoder)

        steps_per_epoch = max(len(train_set) // cfg.train.train_batch_size, 1)
        total = steps_per_epoch * cfg.train.num_train_epochs
        # bf16 compute over f32 masters (TrainConfig.bf16)
        self.state, self.opt = init_train_state(cfg, self.model,
                                                self.doc_encoder, total)
        self.rule = None
        if mesh is not None:
            if mesh.mp > 1:
                self.rule = tp_param_rules(
                    mesh.mp, cfg.mesh.tp_min_size,
                    doc_heads=(self.doc_encoder.cfg.num_heads
                               if self.doc_encoder is not None else 0))
            self.state = shard_state(self.state, mesh, self.rule)
            # the compute copy holds this rank's parts
            load_masters(self.state, self.model, self.doc_encoder)
            # this rank's rows, for the step and (in its layout) the eval
            self.store = place_store(index.store, mesh, self.device)
        else:
            self.store = torch.as_tensor(index.store, device=self.device)
        self.lookup = cluster_docs_lookup(index.cid_of_doc)
        # the evaluator keeps the f32 store, as the step does; its scorers
        # take queries of the compute dtype
        self.evaluator = Evaluator(
            self.model, index.trie,
            self.store if mesh is None else index.store, cfg.eval,
            mesh=mesh, packed=packed_eval)
        self.writer = mesh is None or mesh.rank == 0
        self._neg_kwargs: dict = {}
        if cfg.data.hard_negative and cfg.data.sample_neg_num > 0:
            dl, dm = doc_label_arrays(index.paths, cfg.model)
            self._neg_kwargs = dict(sample_neg_num=cfg.data.sample_neg_num,
                                    doc_labels=dl, doc_label_mask=dm)
        self.ckpt = CheckpointManager.from_config(cfg.train,
                                                  f"{workdir}/ckpt")
        self.logger = (MetricLogger(workdir, run_name="train")
                       if self.writer else NullLogger())
        self.last_epoch_metrics: dict[str, float] = {}
        self.save_seconds: list[tuple[str, float]] = []
        self._refresh_cursor = 0
        self._host_store: Optional[np.ndarray] = None
        self._step_fns: dict[int, Callable] = {}
        self.start_epoch = 0
        step, restored, preempted = self.ckpt.restore_latest(self.device)
        if step is not None:
            if mesh is not None:
                restored = shard_state(restored, mesh, self.rule)
            self.state = restored
            load_masters(self.state, self.model, self.doc_encoder)
            self.start_epoch = step if preempted else step + 1
            if self.writer:
                print(f"resumed from checkpoint step {step}"
                      + (" (mid-epoch preemption: re-running the epoch)"
                         if preempted else ""), file=sys.stderr)

    def _step_fn(self, stage: int) -> Callable:
        if stage not in self._step_fns:
            self._step_fns[stage] = make_train_step(
                self.model, self.doc_encoder, self.opt, self.cfg, stage=stage,
                mesh=self.mesh)
        return self._step_fns[stage]

    def full_state(self) -> Optional[TrainState]:
        """The state with every leaf whole: on a mesh gathered over the mp
        rows (the ranks of dp row 0 gather, rank 0's result is kept; every
        rank calls it), on the CPU; None on the other ranks."""
        if self.mesh is None:
            return self.state
        if self.mesh.dp_rank != 0:
            return None
        full = unshard_state(self.state, self.mesh)
        return full if self.writer else None

    def _refresh_store(self) -> None:
        """Re-embed the corpus (or the next rotating fraction of it) with
        the live tower into the store the step and the evaluator read."""
        n = len(self.doc_tokens)
        frac = self.cfg.train.stage2_refresh_fraction
        if frac >= 1.0:
            self._host_store = embed_corpus(self.doc_encoder, self.doc_tokens,
                                            self.doc_tok_mask,
                                            batch_size=min(256, n),
                                            mesh=self.mesh)
        else:
            take = max(int(n * frac), 1)
            idx = np.arange(self._refresh_cursor,
                            self._refresh_cursor + take) % n
            emb = embed_corpus(self.doc_encoder, self.doc_tokens[idx],
                               self.doc_tok_mask[idx],
                               batch_size=min(256, take), mesh=self.mesh)
            base = (self.index.store if self._host_store is None
                    else self._host_store)
            self._host_store = np.array(base, np.float32, copy=True)
            self._host_store[idx] = emb
            self._refresh_cursor = (self._refresh_cursor + take) % n
        if self.mesh is not None:
            self.store = place_store(self._host_store, self.mesh, self.device)
            self.evaluator.set_store(self._host_store)
            return
        self.store = torch.as_tensor(self._host_store, device=self.device)
        self.evaluator.set_store(self.store)

    def _augment_stage2(self, batch: dict) -> dict:
        idx = batch["cand_idx"]
        batch = dict(batch)
        batch["pos_tokens"] = self.doc_tokens[batch["pos_idx"]]
        batch["pos_tok_mask"] = self.doc_tok_mask[batch["pos_idx"]]
        batch["cand_tokens"] = self.doc_tokens[idx]
        batch["cand_tok_mask"] = self.doc_tok_mask[idx]
        return batch

    def _save(self, kind: str, fn, step: int, *args) -> float:
        """``fn(step, full state, *args)`` on the writing rank, then every
        rank of a mesh waits for it; returns the seconds it took."""
        t = time.perf_counter()
        full = self.full_state()
        if full is not None:
            fn(step, full, *args)
        if self.mesh is not None:
            self.mesh.barrier()
        secs = time.perf_counter() - t
        self.save_seconds.append((kind, secs))
        return secs

    def run(self, max_epochs: Optional[int] = None,
            deadline: Optional[float] = None,
            guard: Optional[PreemptionGuard] = None) -> dict[str, float]:
        """Train to ``max_epochs`` (default ``num_train_epochs``); returns
        the metrics of the best eval epoch.  ``deadline``: an absolute
        ``time.time()`` past which training stops at the next epoch
        boundary.  ``guard``: a preemption guard to poll (default: one
        installed on SIGTERM / SIGINT for the run)."""
        if guard is not None:
            return self._run(guard, max_epochs, deadline)
        with PreemptionGuard() as guard:
            return self._run(guard, max_epochs, deadline)

    def _run(self, guard, max_epochs, deadline) -> dict[str, float]:
        cfg = self.cfg.train
        epochs = max_epochs or cfg.num_train_epochs
        best: dict[str, float] = {}
        step_seed = fold_in(self.seed, 17)

        def _epoch_steps(e: int) -> int:
            s2 = e > cfg.train_encoder_epoch and self.doc_tokens is not None
            b = cfg.stage2_train_batch_size if s2 else cfg.train_batch_size
            return max(len(self.train_set) // max(b, 1), 1)

        global_step = sum(_epoch_steps(e) for e in range(self.start_epoch))
        for epoch in range(self.start_epoch, epochs):
            stage2 = (epoch > cfg.train_encoder_epoch
                      and self.doc_tokens is not None)
            stage = 2 if stage2 else 1
            bsz = (cfg.stage2_train_batch_size if stage2
                   else cfg.train_batch_size)
            it = BatchIterator(self.train_set, self.lookup, bsz,
                               self.cfg.data.max_intraclass_num,
                               seed=epoch, **self._neg_kwargs)
            step_fn = self._step_fn(stage)
            t0 = time.perf_counter()
            losses, rank_losses = [], []
            for batch in it:
                if stage2:
                    batch = self._augment_stage2(batch)
                if (self.cfg.model.weight_distillation > 0
                        and self.index.trie.node_embedding is not None):
                    pe, pm = prefix_node_embeddings(
                        self.index.trie, batch["labels"],
                        batch["label_mask"], self.cfg.model.kary,
                        self.cfg.model.position)
                    batch = dict(batch, prefix_emb=pe, prefix_emb_mask=pm)
                self.state, m = step_fn(self.state, batch, self.store,
                                        step_seed)
                global_step += 1
                # device scalars: a float() per step would sync the host
                losses.append(m["loss"])
                if "ranking_loss" in m:
                    rank_losses.append(m["ranking_loss"])
                if global_step % cfg.log_every_steps == 0:
                    vals = {k: float(v) for k, v in m.items()}
                    if not np.isfinite(vals["loss"]):
                        raise FloatingPointError(
                            f"non-finite loss at step {global_step} "
                            f"(epoch {epoch}): {vals}")
                    self.logger.log(vals, global_step)
                stop = guard.should_stop
                if self.mesh is not None:
                    stop = self.mesh.any_rank(stop)
                if stop:
                    # preempted: persist a resume point and return; the
                    # epoch runs again from its first batch on resume
                    self._save("resume", self.ckpt.save_preemption, epoch)
                    self.logger.log({"preempted": 1}, global_step)
                    self.logger.close()
                    return best
            losses = [float(v) for v in losses]
            avg_loss = float(np.mean(losses)) if losses else 0.0
            if losses and not np.isfinite(avg_loss):
                bad = next(i for i, v in enumerate(losses)
                           if not np.isfinite(v))
                raise FloatingPointError(
                    f"non-finite loss in epoch {epoch} (first at batch "
                    f"{bad}: {losses[bad]})")
            metrics = {"epoch": epoch, "stage": stage,
                       "avg_train_loss": avg_loss,
                       "epoch_seconds": time.perf_counter() - t0}
            if rank_losses:
                metrics["avg_ranking_loss"] = float(
                    np.mean([float(v) for v in rank_losses]))
            eval_bs = (cfg.stage2_eval_batch_size if stage2
                       else cfg.eval_batch_size)
            with whole_weights(self.state, self.model, self.doc_encoder,
                               self.mesh):
                if stage2:
                    t_ref = time.perf_counter()
                    self._refresh_store()
                    metrics["store_refresh_seconds"] = (
                        time.perf_counter() - t_ref)
                metrics.update(self.evaluator.evaluate(
                    self.dev, batch_size=max(eval_bs, 1)))
            metrics["checkpoint_seconds"] = self._save(
                "best", self.ckpt.save, epoch, metrics)
            if not best or metrics.get(cfg.monitor, 0) >= best.get(
                    cfg.monitor, float("-inf")):
                best = dict(metrics)
            self.logger.log(metrics, global_step)
            self.last_epoch_metrics = metrics
            # the latest-1 resume point, kept apart from best-k retention
            self._save("resume", self.ckpt.save_preemption, epoch + 1)
            past = deadline is not None and time.time() >= deadline
            if self.mesh is not None:
                past = self.mesh.any_rank(past)
            if past:
                self.logger.log({"deadline_stop_epoch": epoch}, global_step)
                break
        self.logger.close()
        return best
