"""Encoder-only classification (the reference's ``--softmax`` path),
mirroring ``gdr_tpu/models/classifier.py``: the T5 encoder, then a biased
linear head ``fc`` over the first position's state into ``num_cls``
classes, f32 logits.  Plain PyTorch: the reference has no kernel here."""

from __future__ import annotations

import torch
from torch import nn

from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.models.t5 import Encoder


class EncoderClassifier(nn.Module):
    def __init__(self, cfg: ModelConfig, num_cls: int):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.num_cls = num_cls
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        # the reference builds this encoder with the default rel-bias
        # buckets (32) and distance (128), whatever the config says
        self.encoder = Encoder(c.num_layers, c.d_model, c.num_heads, c.d_kv,
                               c.d_ff, c.layer_norm_epsilon,
                               dropout_rate=c.dropout_rate)
        self.fc = nn.Linear(c.d_model, num_cls)
        self.eval()

    def forward(self, input_ids, attn_mask) -> torch.Tensor:
        """Class logits [B, num_cls] f32."""
        enc = self.encoder(self.shared(input_ids), attn_mask)
        x = enc[:, 0]
        w = self.fc.weight
        # in the model dtype, the bias added after the product is rounded
        return (torch.nn.functional.linear(x.to(w.dtype), w)
                + self.fc.bias).float()

    def predict(self, input_ids, attn_mask) -> torch.Tensor:
        """argmax class."""
        return torch.argmax(self(input_ids, attn_mask), dim=-1)
