"""The train step, mirroring ``gdr_tpu/train/trainer.py``'s loss and update:

- R-Drop: the batch is duplicated (the second half from ``aug_input_ids``
  when given), and with probability ``input_dropout`` 10% of the input
  tokens are zeroed;
- CID generation CE (over each position's candidate slots when the head
  is sliced) plus ``rdrop`` × the R-Drop consistency (Contrast, KL or L2);
- the aux losses: embedding and weight distillation, denoising, and the
  hard-negative margin ranking loss when the batch has ``neg_labels``;
- cluster-adaptive InfoNCE between the query rep and the positive's
  cluster: doc embeddings gathered from the store in stage 1, from the live
  doc tower in stage 2;
- the six-group AdamW update (``train/optimizer.py``).

**Precision.**  The optimizer holds f32 master parameters (``TrainState.
params``) and f32 moments.  The models compute in their own dtype (bf16
when ``TrainConfig.bf16``): after every update the masters are copied into
them, which is the reference's cast at use.  The backward runs in the
compute dtype and its gradients are upcast to f32 before the clip.

**Randomness.**  Each step draws from one ``torch.Generator`` on the model's
device, seeded by (``seed``, step): the input-dropout gate and keep mask,
the modules' dropout, the denoising keep mask and its Gumbel noise.  The
reference splits a JAX key five ways; its draws can be handed in through
``noise`` (``input_gate``, ``input_keep`` [2B, S], ``denoise_keep``
[B, S], ``denoise_gumbel`` [B, S, vocab]), the modules' dropout excepted.
The passes that the reference runs deterministically (weight
distillation's head vectors, denoising, the negatives' decode) run with
the model in eval mode.

**Over a mesh** (``make_train_step(mesh=)``, one process per GPU).  The
step takes the global host batch and keeps this rank's dp rows
(``parallel/mesh.py::shard_batch``).  Its loss is the global batch's, as
``gdr_tpu``'s SPMD program computes it:

- the step's own draws (input-dropout gate and keep mask, denoising keep
  mask and Gumbel noise) are drawn at the global batch's shape from the
  step's generator, then sliced to the rank's rows, so dp = N equals one
  process at module dropout 0; the modules' dropout draws from a generator
  that folds in the dp rank, so that dp ranks do not share masks (the mp
  ranks of a row do: each draws the whole mask and keeps its part);
- the store is row-sharded over every rank: the step's store rows (the
  positives and candidates of the global batch) come from their owners
  in one SUM all-reduce (``fetch_rows``);
- each loss is this rank's share of the global loss (``ops/losses.py``,
  ``dp``), its row-coupled terms against keys gathered from every dp rank
  through a differentiable all-gather; the f32 gradients are summed over
  each dp column after the backward, and the metrics too;
- over the mp row the step is column-parallel, as ``gdr_tpu``'s SPMD step:
  each leaf that ``parallel/mesh.py::tp_param_rules`` selects is held by a
  rank as its part only (f32 master, moments and the compute copy alike,
  :func:`shard_state`), and the rank computes only its part of each
  product over it, forward and backward (the models read the mesh that
  :func:`compute_grads` sets; ``parallel/autograd.py``).  Its gradient is
  the part's; the activations are gathered or summed over the row between
  the products, so every rank of the row holds the same loss and the same
  gradients of the whole leaves.  The clip's norm sums the parts' squares
  over the row (``train/optimizer.py``), the update touches the parts, and
  :func:`load_masters` copies each rank's master parts into its compute
  copy without a collective.  Outside the step (the eval, the store's
  re-embedding, checkpoints) the weights are made whole over the row
  (:func:`whole_weights`, :func:`unshard_state`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from gdr_tpu_torch.config import GDRConfig
from gdr_tpu_torch.models.gdr import GenerativeRetriever, shift_right
from gdr_tpu_torch.models.t5 import set_dropout_generator
from gdr_tpu_torch.ops import losses
from gdr_tpu_torch.ops.beam import gumbel_noise
from gdr_tpu_torch.parallel.autograd import DPShards, set_mp_mesh
from gdr_tpu_torch.parallel.mesh import (Cut, fetch_rows, shard_batch,
                                         shard_params, unshard_params)
from gdr_tpu_torch.train.optimizer import (GroupedAdamW, build_optimizer,
                                           global_norm)
from gdr_tpu_torch.utils.rng import fold_in, generator

TOWERS = ("generator", "doc_encoder")


@dataclass
class TrainState:
    params: dict[str, dict[str, torch.Tensor]]   # f32 masters per tower
    opt_state: dict
    step: int
    # ``<tower>/<name>`` → Cut of each leaf held as this rank's mp part
    cuts: dict[str, Cut] = field(default_factory=dict)


@contextlib.contextmanager
def deterministic(model: torch.nn.Module):
    """Run a pass of ``model`` without dropout, then restore its mode."""
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


def _load(p: torch.Tensor, value: torch.Tensor) -> None:
    """``value`` into parameter ``p`` in its dtype, in place; where the
    shapes differ (an mp part replacing the whole leaf or the reverse) ``p``
    gets a new tensor first.  Every load bumps ``p``'s version."""
    if p.shape != value.shape:
        p.data = torch.empty(value.shape, dtype=p.dtype, device=p.device)
    p.copy_(value)


@torch.no_grad()
def load_masters(state: TrainState, model: GenerativeRetriever,
                 doc_encoder=None) -> None:
    """Copy the f32 masters into the models' parameters (in their dtype):
    a master held as this rank's mp part makes the parameter that part.
    No collective."""
    for tower, module in zip(TOWERS, (model, doc_encoder)):
        if module is None:
            continue
        masters = state.params[tower]
        for name, p in module.named_parameters():
            _load(p, masters[name])


@contextlib.contextmanager
def whole_weights(state: TrainState, model: GenerativeRetriever,
                  doc_encoder=None, mesh=None):
    """The models hold whole weights inside the block: each master part is
    gathered over the mp row in the compute dtype (rounding commutes with
    the concatenation), and the parts are loaded back after it, which frees
    the whole copy.  Every rank of the row enters it together."""
    if not state.cuts:
        yield
        return
    with torch.no_grad():
        for tower, module in zip(TOWERS, (model, doc_encoder)):
            if module is None:
                continue
            for name, p in module.named_parameters():
                cut = state.cuts.get(f"{tower}/{name}")
                if cut is not None:
                    _load(p, mesh.all_gather_mp(
                        state.params[tower][name].to(p.dtype), *cut))
    try:
        yield
    finally:
        load_masters(state, model, doc_encoder)


def shard_state(state: TrainState, mesh, rule) -> TrainState:
    """``state`` with the masters, AdamW moments and gradient accumulator
    of each leaf that ``rule`` selects cut to this rank's mp part
    (``gdr_tpu``'s ``shard_params`` of params and opt_state), and
    ``cuts`` naming them."""
    params, cuts = shard_params(state.params, mesh, rule)
    opt = dict(state.opt_state)
    for k in ("mu", "nu", "acc"):
        if opt.get(k) is not None:
            opt[k] = shard_params(opt[k], mesh, rule)[0]
    return TrainState(params=params, opt_state=opt, step=state.step,
                      cuts=cuts)


def unshard_state(state: TrainState, mesh) -> TrainState:
    """The inverse of :func:`shard_state`, leaf by leaf on the CPU; every
    rank of the mp row calls it."""
    opt = dict(state.opt_state)
    for k in ("mu", "nu", "acc"):
        if opt.get(k) is not None:
            opt[k] = unshard_params(opt[k], state.cuts, mesh, "cpu")
    return TrainState(params=unshard_params(state.params, state.cuts, mesh,
                                            "cpu"),
                      opt_state=opt, step=state.step)


def init_train_state(cfg: GDRConfig, model: GenerativeRetriever,
                     doc_encoder, total_steps: int
                     ) -> tuple[TrainState, GroupedAdamW]:
    """f32 masters cloned from the models' current weights, the optimizer
    and its zero state; then the models are cast to the compute dtype (bf16
    when ``cfg.train.bf16``) and left holding the masters."""
    params = {"generator": {n: p.detach().float().clone()
                            for n, p in model.named_parameters()}}
    if doc_encoder is not None:
        params["doc_encoder"] = {n: p.detach().float().clone()
                                 for n, p in doc_encoder.named_parameters()}
    opt, _ = build_optimizer(cfg.train, params, total_steps)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    dtype = torch.bfloat16 if cfg.train.bf16 else torch.float32
    for module in (model, doc_encoder):
        if module is not None:
            module.to(dtype)
    load_masters(state, model, doc_encoder)
    return state, opt


def _device_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def make_loss_fn(model: GenerativeRetriever, doc_encoder, cfg: GDRConfig,
                 stage: int = 1) -> Callable:
    """``loss_fn(batch, store, gen, noise, dp=None, rows=None) -> (total,
    metrics)`` on device tensors, with the model in train mode.

    Batch fields: input_ids [B, S], attn_mask [B, S], labels [B, L],
    label_mask [B, L], pos_idx [B], cand_idx [B, C], cand_mask [B, C]
    (stage 1); pos_tokens / pos_tok_mask [B, Le], cand_tokens /
    cand_tok_mask [B, C, Le] (stage 2); optional aug_input_ids /
    aug_attn_mask, prefix_emb / prefix_emb_mask, neg_labels /
    neg_label_mask [B, N, L].  ``store``: the [N, d] doc embeddings.

    Over dp ranks (``dp``, ``parallel/autograd.py::DPShards``): ``batch``
    holds this rank's rows, every loss is its share of the global loss,
    and ``rows`` replaces the store: ``pos`` (this rank's positives' store
    rows, when read), ``cand`` (the global batch's candidates' rows, stage
    1) and ``cand_mask`` (the global batch's)."""
    mcfg, tcfg = cfg.model, cfg.train
    sliced = mcfg.position and (not mcfg.adaptor_decode
                                or mcfg.adaptor_efficient)
    head = (model.decode_candidate_logits if sliced
            else model.decode_logits)

    def loss_fn(batch, store, gen, noise, dp=None, rows=None):
        noise = noise or {}
        dev = batch["input_ids"].device
        b = batch["input_ids"].shape[0]
        input_ids = torch.cat([batch["input_ids"],
                               batch.get("aug_input_ids",
                                         batch["input_ids"])])
        attn = torch.cat([batch["attn_mask"],
                          batch.get("aug_attn_mask", batch["attn_mask"])])
        labels = torch.cat([batch["labels"]] * 2)
        label_mask = torch.cat([batch["label_mask"]] * 2)

        if mcfg.input_dropout > 0:
            gate = noise.get("input_gate")
            if gate is None:
                gate = torch.rand((), generator=gen, device=dev) \
                    < mcfg.input_dropout
            keep = noise.get("input_keep")
            if keep is None:
                keep = torch.rand(input_ids.shape, generator=gen,
                                  device=dev) < 0.9
            gate = torch.as_tensor(gate, device=dev)
            keep = torch.as_tensor(keep, device=dev)
            input_ids = torch.where(gate & ~keep,
                                    torch.zeros_like(input_ids), input_ids)

        dec_in = shift_right(labels)
        out = model(input_ids, attn, dec_in, label_mask, sliced_head=sliced)
        ce_labels = (losses.local_candidate_labels(labels, mcfg.kary)
                     if sliced else labels)
        ce = losses.masked_cross_entropy(out["logits"], ce_labels,
                                         label_mask, dp)
        if mcfg.rdrop_loss == "Contrast":
            rdrop = losses.rdrop_contrast_loss(
                model._scaled(out["decoder_hidden"]), label_mask, dp)
        elif mcfg.rdrop_loss == "KL":
            rdrop = losses.rdrop_kl_loss(out["logits"])
        else:                                   # "L2"
            rdrop = losses.rdrop_l2_loss(
                out["logits"],
                norm_cols=mcfg.decode_vocab_size if sliced else None, dp=dp)
        nci_loss = ce + mcfg.rdrop * rdrop
        metrics: dict[str, torch.Tensor] = {}

        if rows is None:                 # one process: the whole store
            rows = {"cand_mask": batch["cand_mask"],
                    "pos": store[batch["pos_idx"].long()],
                    "cand": (store[batch["cand_idx"].long()] if stage == 1
                             else None)}
        if mcfg.embedding_distillation > 0:
            enc_p = model.project_query(out["encoder_hidden"][:b])
            edl = losses.embedding_distillation_loss(
                enc_p, batch["input_ids"], rows["pos"], dp)
            nci_loss = nci_loss + mcfg.embedding_distillation * edl
            metrics["embed_distill"] = edl
        if mcfg.weight_distillation > 0 and "prefix_emb" in batch:
            with deterministic(model):
                vec = model.label_head_vectors(dec_in[:b], batch["labels"])
            wdl = losses.weight_distillation_loss(
                vec, batch["prefix_emb"], batch["prefix_emb_mask"], dp)
            nci_loss = nci_loss + mcfg.weight_distillation * wdl
            metrics["weight_distill"] = wdl
        if mcfg.denoising:
            keep = noise.get("denoise_keep")
            if keep is None:
                keep = torch.rand(batch["input_ids"].shape, generator=gen,
                                  device=dev) < 0.9
            gumbel = noise.get("denoise_gumbel")
            if gumbel is not None:
                gumbel = torch.as_tensor(gumbel, device=dev)
            with deterministic(model):
                gen_loss, disc_loss = model.denoise(
                    batch["input_ids"], batch["attn_mask"],
                    torch.as_tensor(keep, device=dev), gumbel=gumbel,
                    generator=gen, dp=dp)
            nci_loss = nci_loss + gen_loss + disc_loss

        query = out["query_embedding"][:b]
        if stage == 1:
            pos_emb, cand_emb = rows["pos"], rows["cand"]
        else:
            pos_emb = doc_encoder(batch["pos_tokens"].long(),
                                  batch["pos_tok_mask"])
            c = batch["cand_tokens"].shape[1]
            cand_emb = doc_encoder(
                batch["cand_tokens"].reshape(b * c, -1).long(),
                batch["cand_tok_mask"].reshape(b * c, -1)
            ).reshape(b, c, -1)
            if dp is not None:
                cand_emb = dp.gather(cand_emb.float())
        contrast = losses.cluster_infonce(
            query, pos_emb, cand_emb, rows["cand_mask"], tau=tcfg.tau,
            intra_rate=tcfg.intra_rate, squash=tcfg.loss_func, dp=dp)

        total = nci_loss + contrast
        metrics = {"nci_loss": nci_loss, "ce": ce, "rdrop": rdrop,
                   "contrast_loss": contrast, **metrics}

        if "neg_labels" in batch:
            # teacher-force the negatives' CIDs against the same queries and
            # push each position's positive token probability above the best
            # negative token's by a margin of 0.5
            neg = batch["neg_labels"]
            bsz, n, l = neg.shape
            neg_mask = batch["neg_label_mask"].reshape(bsz * n, l)
            enc_rep = out["encoder_hidden"][:b].repeat_interleave(n, dim=0)
            attn_rep = batch["attn_mask"].repeat_interleave(n, dim=0)
            with deterministic(model):
                neg_logits, _ = head(enc_rep, attn_rep,
                                     shift_right(neg.reshape(bsz * n, l)),
                                     neg_mask)
            pos_prob = torch.softmax(out["logits"][:b].float(), -1).gather(
                -1, ce_labels[:b, :, None].long())[..., 0]
            # padded label positions count as probability 1
            pos_prob = torch.where(batch["label_mask"] > 0, pos_prob,
                                   torch.ones_like(pos_prob))
            neg_prob = torch.softmax(neg_logits.float(), -1).amax(-1)
            # past a negative CID's end: -1, so that the hinge is 0
            neg_prob = torch.where(neg_mask > 0, neg_prob,
                                   torch.full_like(neg_prob, -1.0))
            rank = losses.margin_ranking_loss(
                pos_prob[:, None], neg_prob.reshape(bsz, n, l), margin=0.5,
                dp=dp)
            total = total + rank
            metrics["ranking_loss"] = rank

        metrics["loss"] = total
        return total, metrics

    return loss_fn


def compute_grads(model: GenerativeRetriever, doc_encoder, loss_fn,
                  batch: dict, store, gen, noise=None, dp=None, rows=None,
                  dropout_gen=None, mp=None
                  ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """One forward and backward in train mode: (metrics, f32 gradients by
    flat key ``<tower>/<name>``, of the parameter's shape: a part's where
    it holds an mp part; zeros where a parameter got none).  The modules'
    dropout draws from ``dropout_gen`` (default ``gen``); ``mp``: the mesh
    whose mp row cuts the models' leaves."""
    modules = [(t, m) for t, m in zip(TOWERS, (model, doc_encoder))
               if m is not None]
    for _, m in modules:
        m.zero_grad(set_to_none=True)
        m.train()
        set_mp_mesh(m, mp)
    set_dropout_generator(model, dropout_gen or gen)
    try:
        total, metrics = loss_fn(batch, store, gen, noise, dp, rows)
        total.backward()
    finally:
        for _, m in modules:
            m.eval()
            set_mp_mesh(m, None)
        set_dropout_generator(model, None)
    grads = {}
    for tower, m in modules:
        for name, p in m.named_parameters():
            grads[f"{tower}/{name}"] = (
                torch.zeros(p.shape, device=p.device) if p.grad is None
                else p.grad.float())
            p.grad = None
    return {k: v.detach() for k, v in metrics.items()}, grads


def _global_draws(batch: dict, cfg: GDRConfig, gen, noise: dict | None,
                  mesh, vocab: int, dev) -> dict:
    """The step's draws at the global batch's shape, in the order one
    process draws them (at module dropout 0), sliced to this rank's rows:
    ``noise`` entries are taken as global draws where given."""
    noise = dict(noise or {})
    mcfg = cfg.model
    bsz, seq = np.shape(batch["input_ids"])
    b = bsz // mesh.dp
    lo, hi = mesh.dp_rank * b, (mesh.dp_rank + 1) * b

    def drawn(key, shape, draw):
        v = noise.get(key)
        return torch.as_tensor(v, device=dev) if v is not None else draw(shape)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    if mcfg.input_dropout > 0:
        noise["input_gate"] = drawn("input_gate", (),
                                    lambda s: rand(s) < mcfg.input_dropout)
        keep = drawn("input_keep", (2 * bsz, seq), lambda s: rand(s) < 0.9)
        noise["input_keep"] = torch.cat([keep[lo:hi],
                                         keep[bsz + lo:bsz + hi]])
    if mcfg.denoising:
        keep = drawn("denoise_keep", (bsz, seq), lambda s: rand(s) < 0.9)
        gumbel = drawn("denoise_gumbel", (bsz, seq, vocab),
                       lambda s: gumbel_noise(s, gen))
        noise["denoise_keep"] = keep[lo:hi]
        noise["denoise_gumbel"] = gumbel[lo:hi]
    return noise


def _store_rows(batch: dict, store_local, stage: int, cfg: GDRConfig, mesh,
                dev) -> dict:
    """The store rows the step reads, from their owners: this rank's
    positives (stage 1, or for embedding distillation) and the global
    batch's candidates (stage 1), with the global candidate mask."""
    rows = {"cand_mask": torch.as_tensor(np.asarray(batch["cand_mask"]),
                                         device=dev),
            "pos": None, "cand": None}
    b = len(batch["pos_idx"]) // mesh.dp
    lo = mesh.dp_rank * b
    pos_idx = np.asarray(batch["pos_idx"])[:, None]
    if stage == 1:
        got = fetch_rows(store_local, np.concatenate(
            [pos_idx, np.asarray(batch["cand_idx"])], axis=1), mesh)
        rows["pos"], rows["cand"] = got[lo:lo + b, 0], got[:, 1:]
    elif cfg.model.embedding_distillation > 0:
        rows["pos"] = fetch_rows(store_local, pos_idx, mesh)[lo:lo + b, 0]
    return rows


def make_train_step(model: GenerativeRetriever, doc_encoder,
                    opt: GroupedAdamW, cfg: GDRConfig, stage: int = 1,
                    mesh=None) -> Callable:
    """``train_step(state, batch, store, seed, noise=None) -> (state,
    metrics)``: the step's generator is seeded by (``seed``,
    ``state.step``); ``batch`` holds host or device arrays; the metrics are
    device scalars, ``grad_norm`` the norm of this step's gradients before
    the clip.  The models hold the updated masters afterwards, in eval
    mode.

    With ``mesh`` (``parallel/mesh.py``): ``batch`` is the global host
    batch, the same on every rank; ``store`` this rank's rows
    (``parallel/store.py::place_store``); ``noise`` holds global draws; the
    metrics are the global batch's, equal on every rank; ``state`` holds
    this rank's mp parts (:func:`shard_state`) and the models those parts
    of their compute copy (:func:`load_masters`)."""
    model.cfg.refuse_experts("train_step")
    loss_fn = make_loss_fn(model, doc_encoder, cfg, stage)

    def train_step(state: TrainState, batch: dict, store, seed: int,
                   noise: dict[str, Any] | None = None):
        dev = model.device
        gen = generator(seed, state.step, dev)
        if mesh is None:
            metrics, grads = compute_grads(model, doc_encoder, loss_fn,
                                           _device_batch(batch, dev), store,
                                           gen, noise)
        else:
            noise = _global_draws(batch, cfg, gen, noise, mesh,
                                  model.shared.weight.shape[0], dev)
            rows = _store_rows(batch, store, stage, cfg, mesh, dev)
            local = _device_batch(shard_batch(batch, mesh), dev)
            metrics, grads = compute_grads(
                model, doc_encoder, loss_fn, local, None, gen, noise,
                dp=DPShards(mesh), rows=rows,
                dropout_gen=generator(fold_in(seed, mesh.dp_rank),
                                      state.step, dev),
                mp=mesh if state.cuts else None)
            mesh.all_reduce_dp(list(grads.values()))
            names = list(metrics)
            summed = mesh.sum_dp(torch.stack([metrics[k].float()
                                              for k in names]))
            metrics = dict(zip(names, summed.unbind()))
        if state.cuts:
            metrics["grad_norm"] = global_norm(
                grads.values(), mesh, [k in state.cuts for k in grads])
        else:
            metrics["grad_norm"] = global_norm(grads.values())
        if opt.update(state.params, grads, state.opt_state, mesh,
                      set(state.cuts)):
            load_masters(state, model, doc_encoder)
        state.step += 1
        return state, metrics

    return train_step
