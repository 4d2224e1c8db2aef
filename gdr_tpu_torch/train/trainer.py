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
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from gdr_tpu_torch.config import GDRConfig
from gdr_tpu_torch.models.gdr import GenerativeRetriever, shift_right
from gdr_tpu_torch.models.t5 import set_dropout_generator
from gdr_tpu_torch.ops import losses
from gdr_tpu_torch.train.optimizer import (GroupedAdamW, build_optimizer,
                                           global_norm)
from gdr_tpu_torch.utils.rng import generator

TOWERS = ("generator", "doc_encoder")


@dataclass
class TrainState:
    params: dict[str, dict[str, torch.Tensor]]   # f32 masters per tower
    opt_state: dict
    step: int


@contextlib.contextmanager
def deterministic(model: torch.nn.Module):
    """Run a pass of ``model`` without dropout, then restore its mode."""
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


@torch.no_grad()
def load_masters(state: TrainState, model: GenerativeRetriever,
                 doc_encoder=None) -> None:
    """Copy the f32 masters into the models' parameters (in their dtype)."""
    for tower, module in zip(TOWERS, (model, doc_encoder)):
        if module is None:
            continue
        masters = state.params[tower]
        for name, p in module.named_parameters():
            p.copy_(masters[name])


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
    """``loss_fn(batch, store, gen, noise) -> (total, metrics)`` on device
    tensors, with the model in train mode.

    Batch fields: input_ids [B, S], attn_mask [B, S], labels [B, L],
    label_mask [B, L], pos_idx [B], cand_idx [B, C], cand_mask [B, C]
    (stage 1); pos_tokens / pos_tok_mask [B, Le], cand_tokens /
    cand_tok_mask [B, C, Le] (stage 2); optional aug_input_ids /
    aug_attn_mask, prefix_emb / prefix_emb_mask, neg_labels /
    neg_label_mask [B, N, L].  ``store``: the [N, d] doc embeddings."""
    mcfg, tcfg = cfg.model, cfg.train
    sliced = mcfg.position and (not mcfg.adaptor_decode
                                or mcfg.adaptor_efficient)
    head = (model.decode_candidate_logits if sliced
            else model.decode_logits)

    def loss_fn(batch, store, gen, noise):
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
                                         label_mask)
        if mcfg.rdrop_loss == "Contrast":
            rdrop = losses.rdrop_contrast_loss(
                model._scaled(out["decoder_hidden"]), label_mask)
        elif mcfg.rdrop_loss == "KL":
            rdrop = losses.rdrop_kl_loss(out["logits"])
        else:                                   # "L2"
            rdrop = losses.rdrop_l2_loss(
                out["logits"],
                norm_cols=mcfg.decode_vocab_size if sliced else None)
        nci_loss = ce + mcfg.rdrop * rdrop
        metrics: dict[str, torch.Tensor] = {}

        if mcfg.embedding_distillation > 0:
            enc_p = model.project_query(out["encoder_hidden"][:b])
            edl = losses.embedding_distillation_loss(
                enc_p, batch["input_ids"], store[batch["pos_idx"].long()])
            nci_loss = nci_loss + mcfg.embedding_distillation * edl
            metrics["embed_distill"] = edl
        if mcfg.weight_distillation > 0 and "prefix_emb" in batch:
            with deterministic(model):
                vec = model.label_head_vectors(dec_in[:b], batch["labels"])
            wdl = losses.weight_distillation_loss(
                vec, batch["prefix_emb"], batch["prefix_emb_mask"])
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
                    generator=gen)
            nci_loss = nci_loss + gen_loss + disc_loss

        query = out["query_embedding"][:b]
        if stage == 1:
            pos_emb = store[batch["pos_idx"].long()]
            cand_emb = store[batch["cand_idx"].long()]
        else:
            pos_emb = doc_encoder(batch["pos_tokens"].long(),
                                  batch["pos_tok_mask"])
            c = batch["cand_tokens"].shape[1]
            cand_emb = doc_encoder(
                batch["cand_tokens"].reshape(b * c, -1).long(),
                batch["cand_tok_mask"].reshape(b * c, -1)
            ).reshape(b, c, -1)
        contrast = losses.cluster_infonce(
            query, pos_emb, cand_emb, batch["cand_mask"], tau=tcfg.tau,
            intra_rate=tcfg.intra_rate, squash=tcfg.loss_func)

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
                pos_prob[:, None], neg_prob.reshape(bsz, n, l), margin=0.5)
            total = total + rank
            metrics["ranking_loss"] = rank

        metrics["loss"] = total
        return total, metrics

    return loss_fn


def compute_grads(model: GenerativeRetriever, doc_encoder, loss_fn,
                  batch: dict, store, gen, noise=None
                  ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """One forward and backward in train mode: (metrics, f32 gradients by
    flat key ``<tower>/<name>``; zeros where a parameter got none)."""
    modules = [(t, m) for t, m in zip(TOWERS, (model, doc_encoder))
               if m is not None]
    for _, m in modules:
        m.zero_grad(set_to_none=True)
        m.train()
    set_dropout_generator(model, gen)
    try:
        total, metrics = loss_fn(batch, store, gen, noise)
        total.backward()
    finally:
        for _, m in modules:
            m.eval()
        set_dropout_generator(model, None)
    grads = {}
    for tower, m in modules:
        for name, p in m.named_parameters():
            grads[f"{tower}/{name}"] = (
                torch.zeros(p.shape, device=p.device) if p.grad is None
                else p.grad.float())
            p.grad = None
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: GenerativeRetriever, doc_encoder,
                    opt: GroupedAdamW, cfg: GDRConfig, stage: int = 1
                    ) -> Callable:
    """``train_step(state, batch, store, seed, noise=None) -> (state,
    metrics)``: the step's generator is seeded by (``seed``,
    ``state.step``); ``batch`` holds host or device arrays; the metrics are
    device scalars, ``grad_norm`` the norm of this step's gradients before
    the clip.  The models hold the updated masters afterwards, in eval
    mode."""
    loss_fn = make_loss_fn(model, doc_encoder, cfg, stage)

    def train_step(state: TrainState, batch: dict, store, seed: int,
                   noise: dict[str, Any] | None = None):
        dev = model.device
        gen = generator(seed, state.step, dev)
        metrics, grads = compute_grads(model, doc_encoder, loss_fn,
                                       _device_batch(batch, dev), store,
                                       gen, noise)
        metrics["grad_norm"] = global_norm(grads.values())
        if opt.update(state.params, grads, state.opt_state):
            load_masters(state, model, doc_encoder)
        state.step += 1
        return state, metrics

    return train_step
