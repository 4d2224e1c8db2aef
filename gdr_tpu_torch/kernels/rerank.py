"""Re-rank scorers, each beside its plain PyTorch version:

- ``packed_scores``: ``sim[r, c] = tanh(q[r] · rows[starts[r] + c])`` over
  the cluster-packed f32 / bf16 store (``csrc/rerank_packed.cu``); replaces
  ``gdr_tpu/ops/pallas/rerank_kernel.py::packed_scores_pallas``;
- ``packed_scores_int8``: the raw ``q[r] · values[starts[r] + c]`` over the
  packed int8 store, with no scale and no tanh (the same source's int8
  instantiation); replaces ``::packed_scores_pallas_int8``.  The caller
  applies the per-row scale and the tanh, as the reference does;
- ``rerank_scores``: ``tanh(q[r] · store[docs[r, c]])``, −1e9 where masked,
  over the plain store (``csrc/rerank_gather.cu``); replaces
  ``::rerank_scores_pallas``.

The packed scorers' callers mask pad candidates (pad rows are zero).  The
packed layout's ``cap``-row tail margin (ops/packed_store.py) keeps
``starts[r] + cap`` inside the store, so those kernels do no bounds
masking; a beam whose block would leave the store scores NaN instead of
reading past it.  The gather scorer reads no row for a masked candidate,
and scores NaN for an unmasked doc id outside the store.

**The device decides**: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises.

**What bounds them on the H100, and the design.**  All three are purely
memory-bound: at the operating point (3,200 beams × 768) the bf16 packed
scorer reads 157 MB of rows, the int8 one 79 MB, the gather scorer about
148 MB of real documents, each for about 0.16 GFLOP.  One block per beam,
one warp per candidate row: the query row (f32, as the TPU kernels cast
it) is staged in shared memory once per block, each lane reads 16-byte
chunks of the candidate row, the warp reduces with shuffles and one lane
writes the result.  No intermediate ``[R, cap, d]`` tensor exists.
"""

from __future__ import annotations

import ctypes

import torch

from gdr_tpu_torch.kernels import build
from gdr_tpu_torch.utils.timing import count, declare

NEG_INF = -1.0e9

WRAPPERS = declare("packed_scores", "packed_scores_int8", "rerank_scores")

_P, _I = ctypes.c_void_p, ctypes.c_int
_PACKED_SIGS = {
    # dtype, rows, starts, q, out, m, beams, d, cap, stream
    "gdr_packed_scores": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
_GATHER_SIGS = {
    # dtype, store, docs, mask, q, out, n, beams, d, cap, stream
    "gdr_rerank_scores": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
_MAX_D = 12_288     # the f32 query row fits the kernels' 48 KB of shared memory


def _packed_dots(rows, starts, query_rows, cap: int):
    idx = starts.long()[:, None] + torch.arange(cap, device=rows.device)
    block = rows[idx].float()                            # [R, cap, d]
    return (block * query_rows.float()[:, None, :]).sum(-1)


def packed_scores_plain(rows, starts, query_rows, cap: int):
    return torch.tanh(_packed_dots(rows, starts, query_rows, cap))


def packed_scores_int8_plain(values, starts, query_rows, cap: int):
    return _packed_dots(values, starts, query_rows, cap)


def rerank_scores_plain(store, docs, query_rows, mask):
    safe = torch.where(mask, docs.long(), 0)             # pad slots read row 0
    cand = store[safe].float()                           # [R, cap, d]
    sim = torch.tanh((cand * query_rows.float()[:, None, :]).sum(-1))
    return torch.where(mask, sim, torch.full_like(sim, NEG_INF))


def _check_cuda(name: str, dev, *tensors) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")


def _check_chunks(name: str, rows, query_rows, d: int) -> None:
    """The kernels read rows in 16-byte chunks and stage the f32 query in
    shared memory."""
    per_chunk = 16 // rows.element_size()
    if d % per_chunk or d > _MAX_D or rows.data_ptr() % 16 \
            or query_rows.data_ptr() % 16:
        raise ValueError(f"{name}: needs d a multiple of {per_chunk} and at "
                         f"most {_MAX_D}, and 16-byte aligned rows and query "
                         f"(d={d})")


def _launch_packed(name: str, rows, starts, query_rows, cap: int):
    dev = rows.device
    query_rows = query_rows.float().contiguous()
    if starts.dtype != torch.int32:
        raise TypeError(f"{name}: starts {starts.dtype}, need int32")
    _check_cuda(name, dev, rows, starts, query_rows)
    r, d = query_rows.shape
    if rows.shape[1] != d or tuple(starts.shape) != (r,):
        raise ValueError(f"{name}: rows {tuple(rows.shape)}, starts "
                         f"{tuple(starts.shape)}, query {tuple(query_rows.shape)}")
    _check_chunks(name, rows, query_rows, d)
    out = torch.empty((r, cap), dtype=torch.float32, device=dev)
    lib = build.load("rerank_packed", _PACKED_SIGS)
    build.check(lib, lib.gdr_packed_scores(
        build.DTYPES[rows.dtype], rows.data_ptr(), starts.data_ptr(),
        query_rows.data_ptr(), out.data_ptr(), rows.shape[0], r, d, cap,
        torch.cuda.current_stream(dev).cuda_stream), name)
    count(name)
    return out


def packed_scores(rows, starts, query_rows, cap: int):
    """rows: the packed store [M, d], float32 or bfloat16; starts: [R] int32
    row starts; query_rows: [R, d], any float dtype (scored in f32).
    Returns tanh of the dots, [R, cap] float32."""
    if rows.device.type == "cpu":
        return packed_scores_plain(rows, starts, query_rows, cap)
    if rows.dtype not in build.FLOAT_DTYPES:
        raise TypeError(f"packed_scores: rows {rows.dtype} (float32 or "
                        f"bfloat16)")
    return _launch_packed("packed_scores", rows, starts, query_rows, cap)


def packed_scores_int8(values, starts, query_rows, cap: int):
    """values: the packed int8 store [M, d]; starts: [R] int32 row starts
    (32-aligned in the reference layout; the kernel needs only 16-byte
    rows, d a multiple of 16); query_rows: [R, d], any float dtype (scored
    in f32).  Returns the raw, unscaled dots, [R, cap] float32."""
    if values.device.type == "cpu":
        return packed_scores_int8_plain(values, starts, query_rows, cap)
    if values.dtype != torch.int8:
        raise TypeError(f"packed_scores_int8: values {values.dtype}, need "
                        f"int8")
    return _launch_packed("packed_scores_int8", values, starts, query_rows,
                          cap)


def rerank_scores(store, docs, query_rows, mask):
    """store: [N, d] float32 or bfloat16; docs: [R, cap] int32 doc ids;
    query_rows: [R, d], any float dtype (scored in f32); mask: [R, cap]
    bool.  Returns tanh of the dots, −1e9 where masked, [R, cap] float32."""
    if store.device.type == "cpu":
        return rerank_scores_plain(store, docs, query_rows, mask)
    name = "rerank_scores"
    dev = store.device
    if store.dtype not in build.FLOAT_DTYPES:
        raise TypeError(f"{name}: store {store.dtype} (float32 or bfloat16)")
    if docs.dtype != torch.int32:
        raise TypeError(f"{name}: docs {docs.dtype}, need int32")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask {mask.dtype}, need bool")
    query_rows = query_rows.float().contiguous()
    _check_cuda(name, dev, store, docs, mask, query_rows)
    r, d = query_rows.shape
    if store.shape[1] != d or docs.dim() != 2 or docs.shape[0] != r \
            or mask.shape != docs.shape:
        raise ValueError(f"{name}: store {tuple(store.shape)}, docs "
                         f"{tuple(docs.shape)}, mask {tuple(mask.shape)}, "
                         f"query {tuple(query_rows.shape)}")
    _check_chunks(name, store, query_rows, d)
    cap = docs.shape[1]
    out = torch.empty((r, cap), dtype=torch.float32, device=dev)
    lib = build.load("rerank_gather", _GATHER_SIGS)
    build.check(lib, lib.gdr_rerank_scores(
        build.DTYPES[store.dtype], store.data_ptr(), docs.data_ptr(),
        mask.data_ptr(), query_rows.data_ptr(), out.data_ptr(),
        store.shape[0], r, d, cap,
        torch.cuda.current_stream(dev).cuda_stream), name)
    count(name)
    return out
