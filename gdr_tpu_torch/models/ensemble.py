"""Multi-decoder ensemble (the reference's ``multiple_decoder`` mode),
mirroring ``gdr_tpu/models/ensemble.py``.

N decoder sides, each with its own decode embeddings, head and PAWA, share
one encoder side (``shared`` and ``encoder``).  Each member learns its own
k-means docid assignment, and evaluation merges the members' retrievals.

The reference stacks the decoder sides along a leading axis and ``vmap``s
them; here :class:`Ensemble` holds N :class:`GenerativeRetriever` members
whose ``shared`` and ``encoder`` are the same modules (member 0's), so
``named_parameters`` lists the encoder side once and ``members[i]`` is a
complete retriever for serving.  :func:`ensemble_logits` runs the encoder
once and the members' decoder sides in a plain loop; in train mode each
member's dropout draws from the step's generator in turn.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights, \
    shift_right
from gdr_tpu_torch.models.t5 import set_dropout_generator
from gdr_tpu_torch.ops import losses as LS

# the parameters owned by the encoder side, shared across the ensemble
ENCODER_SIDE = ("shared", "encoder")


class Ensemble(nn.Module):
    def __init__(self, cfg: ModelConfig, num_decoders: int):
        super().__init__()
        self.cfg = cfg
        self.members = nn.ModuleList(
            [GenerativeRetriever(cfg) for _ in range(num_decoders)])
        first = self.members[0]
        for m in self.members[1:]:
            m.shared = first.shared
            m.encoder = first.encoder
        self.eval()

    def __len__(self) -> int:
        return len(self.members)

    @property
    def device(self) -> torch.device:
        return self.members[0].device

    def side_of(self, name: str) -> str:
        """``enc`` or ``dec``: the side that owns parameter ``name``."""
        inner = name.split(".", 2)[2]             # members.<i>.<owner>...
        return "enc" if inner.split(".", 1)[0] in ENCODER_SIDE else "dec"


def init_ensemble(cfg: ModelConfig, num_decoders: int,
                  generator: torch.Generator) -> Ensemble:
    """N independently initialised members (``models/gdr.py::init_weights``
    from ``generator``, last member first, so that the shared encoder side
    keeps member 0's draw, as the reference's)."""
    with torch.device(generator.device):
        ens = Ensemble(cfg, num_decoders)
    for m in reversed(ens.members):
        init_weights(m, generator)
    return ens


def ensemble_logits(ens: Ensemble, input_ids, attn_mask, labels, label_mask):
    """Teacher-forced (logits [N, B, L, V], decoder states [N, B, L, d]) of
    every member.  ``labels``: [N, B, L], each member's own docid
    assignment.  Dropout runs when the ensemble is in train mode, from the
    generator it was given."""
    first = ens.members[0]
    enc = first.encode(input_ids, attn_mask)
    logits, hidden = [], []
    for i, m in enumerate(ens.members):
        lg, hd = m.decode_logits(enc, attn_mask, shift_right(labels[i]),
                                 label_mask[i])
        logits.append(lg)
        hidden.append(hd)
    return torch.stack(logits), torch.stack(hidden)


def ensemble_loss(ens: Ensemble, batch: dict, rdrop: float = 0.0,
                  rdrop_loss: str = "Contrast"):
    """(mean loss, per-member losses [N]): each member's masked CE, plus
    ``rdrop`` × its R-Drop consistency on the duplicated batch."""
    ids, attn = batch["input_ids"], batch["attn_mask"]
    labels, lmask = batch["labels"], batch["label_mask"]
    if rdrop > 0:
        ids, attn = torch.cat([ids] * 2), torch.cat([attn] * 2)
        labels = torch.cat([labels] * 2, dim=1)
        lmask = torch.cat([lmask] * 2, dim=1)
    logits, hidden = ensemble_logits(ens, ids, attn, labels, lmask)
    per = []
    for i in range(len(ens)):
        loss = LS.masked_cross_entropy(logits[i], labels[i], lmask[i])
        if rdrop > 0:
            if rdrop_loss == "Contrast":
                cons = LS.rdrop_contrast_loss(
                    ens.members[i]._scaled(hidden[i]), lmask[i])
            elif rdrop_loss == "KL":
                cons = LS.rdrop_kl_loss(logits[i])
            else:                                   # "L2"
                cons = LS.rdrop_l2_loss(logits[i])
            loss = loss + rdrop * cons
        per.append(loss)
    per = torch.stack(per)
    return per.mean(), per


def make_ensemble_train_step(ens: Ensemble, opt, rdrop: float = 0.0,
                             rdrop_loss: str = "Contrast"):
    """``step(batch, generator=None) -> (loss, per-member losses)``: the
    members' losses (:func:`ensemble_loss`) and one update of ``opt``
    (``train/optimizer.py::AdamW``).  With a generator the pass runs in
    train mode (dropout from it), without one deterministically; ``rdrop``
    > 0 needs a generator.  Batch: ``input_ids`` / ``attn_mask`` [B, S],
    ``labels`` / ``label_mask`` [N, B, L], on the ensemble's device."""

    def step(batch: dict, generator: torch.Generator | None = None):
        if rdrop > 0 and generator is None:
            raise ValueError("rdrop > 0 needs a generator: the consistency "
                             "term compares two dropout realisations")
        if generator is not None:
            ens.train()
            set_dropout_generator(ens, generator)
        try:
            loss, per = ensemble_loss(ens, batch, rdrop, rdrop_loss)
            loss.backward()
        finally:
            ens.eval()
            set_dropout_generator(ens, None)
        opt.step()
        return loss.detach(), per.detach()

    return step


def merge_retrievals(doc_lists: Sequence[Sequence[str]],
                     score_lists: Sequence[Sequence[float]],
                     top_k: int) -> list[str]:
    """Union the members' ranked doc lists by best fused score."""
    best: dict[str, float] = {}
    for docs, scores in zip(doc_lists, score_lists):
        for d, s in zip(docs, scores):
            if d not in best or s > best[d]:
                best[d] = float(s)
    ranked = sorted(best.items(), key=lambda kv: -kv[1])
    return [d for d, _ in ranked[:top_k]]
