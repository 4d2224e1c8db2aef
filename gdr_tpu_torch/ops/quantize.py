"""Int8 document-embedding stores, mirroring ``gdr_tpu/ops/quantize.py``.

Per-row absmax symmetric quantization makes the store 4× smaller at equal
corpus size (the memory-pressure configuration).  Scoring dequantises on
the fly:

    q · (v_int8 · scale) = scale · (q · v_int8)

so the dot runs over int8 rows with one scalar multiply at the end.

- :class:`QuantizedStore` is the plain layout; the re-rank scores it with
  :func:`quantized_dot` in plain PyTorch on both devices (the reference
  package leaves this to XLA, outside any kernel);
- :class:`PackedQuantizedStore` is the cluster-packed layout
  (ops/packed_store.py) of the same rows; the re-rank reads it through the
  int8 packed scorer (kernels/rerank.py::packed_scores_int8).

``quantize_store`` computes in float32 exactly as the reference does
(``torch.round`` and ``jnp.round`` both round half to even), so values and
scales are bit-equal to it for float32 and bfloat16 inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class QuantizedStore:
    values: torch.Tensor    # int8 [N, d]
    scales: torch.Tensor    # float32 [N]

    @property
    def shape(self):
        return self.values.shape

    @property
    def num_docs(self) -> int:
        return self.values.shape[0]


@dataclass
class PackedQuantizedStore:
    """Cluster-packed int8 store: pad rows carry zero values and zero
    scale."""

    values: torch.Tensor    # int8 [M, d] cluster-contiguous
    scales: torch.Tensor    # float32 [M]

    @property
    def shape(self):
        return self.values.shape


def quantize_store(store) -> QuantizedStore:
    """Per-row absmax int8 quantization of a [N, d] store, computed in
    float32 on the store's device."""
    store = torch.as_tensor(store).float()
    absmax = store.abs().amax(dim=1).clamp_min(1e-9)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is not the reference's rounding
    scales = absmax / torch.full_like(absmax, 127.0)
    values = torch.round(store / scales[:, None]).clamp(-127, 127)
    return QuantizedStore(values=values.to(torch.int8), scales=scales)


def pack_quantized_rows(store, row_to_doc: torch.Tensor
                        ) -> PackedQuantizedStore:
    """Quantize, then lay the rows out cluster-contiguously as
    ``packed_store.pack_rows`` does (per-row absmax commutes with the row
    permutation)."""
    q = quantize_store(store)
    r = row_to_doc.to(q.values.device)
    safe = r.clamp_min(0).long()
    real = r >= 0
    values = torch.where(real[:, None], q.values[safe],
                         torch.zeros((), dtype=torch.int8,
                                     device=q.values.device))
    scales = torch.where(real, q.scales[safe], torch.zeros_like(q.scales[safe]))
    return PackedQuantizedStore(values=values, scales=scales)


def dequantize_rows(qstore: QuantizedStore, idx: torch.Tensor) -> torch.Tensor:
    """Gather and dequantise rows → float32 [..., d]."""
    idx = idx.long()
    return qstore.values[idx].float() * qstore.scales[idx][..., None]


def quantized_dot(query: torch.Tensor, qstore: QuantizedStore,
                  idx: torch.Tensor) -> torch.Tensor:
    """scores[..., c] = query · store[idx[..., c]], dequantised on the fly.
    query: [..., d], broadcastable against idx [..., C]."""
    idx = idx.long()
    raw = torch.einsum("...d,...cd->...c", query.float(),
                       qstore.values[idx].float())
    return raw * qstore.scales[idx]
