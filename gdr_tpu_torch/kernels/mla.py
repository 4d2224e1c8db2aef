"""Latent attention (MLA, DeepSeek-V2/V3) for one decode step over a
shared query prefix, with its plain PyTorch version.

GDR's decoder-only backbone (``models/deepseek.py``) decodes every beam
row of a query after the same query prefix.  Per layer the prefix keys and
values are made once, at the prefill, and kept per query (``pk`` [B, H, S,
nope + rope], ``pv`` [B, H, S, v]); each beam row keeps its own CID steps'
keys and values (``ck`` [L, R, H, nope + rope], ``cv`` [L, R, H, v],
reordered with the beams).  :func:`mla_attention` takes the step's raw
projections of R = B·W rows (W beams a query):

- ``q`` [R, H·(nope + rope)]: a head's ``nope`` columns, then its ``rope``
  columns in ``transformers``' interleaved order;
- ``kva`` [R, rank + rope]: the latent, then the shared ``k_pe``;
- ``kvb`` [R, H·(nope + v)]: kv_b of the normed latent, a head's k_nope
  then its v;

rotates q_pe and k_pe at position ``lens[b] + pos`` (``lens``: the query's
tokens; RoPE with ``transformers``' de-interleaved rope dimensions:
pair i = (x[2i], x[2i+1]) goes to (a·cos − b·sin, b·cos + a·sin) at
columns i and i + rope/2; with ``rotate`` False, NoPE MLA as Kimi
Linear's, they are taken as they are), writes the row's key and value at ``pos`` of
the caches in place, and returns softmax(scale·q·kᵀ + bias)·v [R, H·v]
over the query's S prefix positions (``bias`` [B, S]: 0, or −1e9 at pads)
and the row's positions ≤ ``pos``, under one softmax.

**The device decides.**  A CPU tensor runs the plain version; a CUDA
tensor launches ``gdr::mla_decode`` (``csrc/mla.cu``), f32 only.  A block
takes one (query, head) and 8 of its beam rows: it stages the query's
prefix keys and values of that head in shared memory once, so the prefix
is never copied per beam, and a warp takes a row.  The launch's grid
depends on the shapes alone, so it captures in a CUDA graph.  The wrapper
counts its calls (``WRAPPERS``).

The decompressed form is used (keys and values expanded by kv_b, as
``transformers`` computes them) rather than the absorbed one (q·W_kbᵀ
against the 512-wide latent): at GDR's ≤ 50 positions the step's bytes
are the projections', and absorbing would add two per-head products of
the rows against W_kv_b's 2 MB to every step.
"""

from __future__ import annotations

import ctypes

import torch

from gdr_tpu_torch.kernels import build
from gdr_tpu_torch.utils.timing import count, declare

WRAPPERS = declare("mla_attention")
NEG_INF = -1.0e9
MAX_PREFIX = 128        # prefix positions a block stages (shared memory)
MAX_STEPS = 32          # a row's own cached steps (kMlaMaxL in the source)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    # q, kva, kvb, pk, pv, bias, lens, ck, cv, inv_freq, out, batch, beams,
    # heads, S, L, pos, rank, scale, rotate, stream
    "gdr_mla_decode": [_P] * 11 + [_I] * 7 + [_F, _I, _P],
}


def rope_inv_freq(rope: int, theta: float, device=None) -> torch.Tensor:
    """[rope / 2] f32 inverse frequencies, as ``transformers``' default
    RoPE computes them."""
    i = torch.arange(0, rope, 2, dtype=torch.int64, device=device).float()
    return 1.0 / (theta ** (i / rope))


def rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor
         ) -> torch.Tensor:
    """x [..., rope] (interleaved pairs) rotated at ``positions``
    (broadcast to x's leading dimensions), de-interleaved."""
    f = positions.float()[..., None] * inv_freq
    c, s = f.cos(), f.sin()
    a, b = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1).to(x.dtype)


def mla_attention_plain(q, kva, kvb, pk, pv, bias, lens, ck, cv, pos: int,
                        inv_freq, num_beams: int, *, scale: float,
                        rotate: bool = True):
    r = q.shape[0]
    b, h, s, dk = pk.shape
    dv = pv.shape[-1]
    rp = inv_freq.shape[0] * 2
    nope = dk - rp
    rank = kva.shape[1] - rp
    positions = (lens.long() + pos).repeat_interleave(num_beams)   # [R]
    qh = q.view(r, h, dk)
    q_pe, k_pe = qh[..., nope:], kva[:, rank:]
    if rotate:
        q_pe = rope(q_pe, positions[:, None], inv_freq)
        k_pe = rope(k_pe, positions, inv_freq)
    qf = torch.cat([qh[..., :nope], q_pe], dim=-1).float()
    kv = kvb.view(r, h, nope + dv)
    ck[pos] = torch.cat([kv[..., :nope], k_pe[:, None].expand(r, h, rp)],
                        dim=-1).to(ck.dtype)
    cv[pos] = kv[..., nope:].to(cv.dtype)
    sp = torch.einsum("bwhd,bhsd->bwhs", qf.view(b, num_beams, h, dk),
                      pk.float()).reshape(r, h, s) * scale
    sp = sp + bias.float().repeat_interleave(num_beams, 0)[:, None]
    ss = torch.einsum("rhd,lrhd->rhl", qf, ck[:pos + 1].float()) * scale
    p = torch.softmax(torch.cat([sp, ss], dim=-1), dim=-1)
    o = torch.einsum("bwhs,bhsd->bwhd", p[..., :s].reshape(b, num_beams, h, s),
                     pv.float()).reshape(r, h, dv)
    o = o + torch.einsum("rhl,lrhd->rhd", p[..., s:], cv[:pos + 1].float())
    return o.reshape(r, h * dv).to(q.dtype)


def _lib():
    return build.load("mla", _SIGS)


def mla_attention(q, kva, kvb, pk, pv, bias, lens, ck, cv, pos: int,
                  inv_freq, num_beams: int, *, scale: float,
                  rotate: bool = True):
    """One decode step's latent attention (see the module's docstring);
    ``ck`` / ``cv`` are written at ``pos`` in place.  Returns [R, H·v]."""
    r = q.shape[0]
    b, h, s, dk = pk.shape
    dv = pv.shape[-1]
    rp = inv_freq.shape[0] * 2
    rank = kva.shape[1] - rp
    lmax = ck.shape[0]
    for name, t, shape in (("q", q, (r, h * dk)), ("kvb", kvb,
                                                    (r, h * (dk - rp + dv))),
                           ("pv", pv, (b, h, s, dv)), ("bias", bias, (b, s)),
                           ("lens", lens, (b,)), ("ck", ck, (lmax, r, h, dk)),
                           ("cv", cv, (lmax, r, h, dv))):
        if tuple(t.shape) != shape:
            raise ValueError(f"mla_attention {name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
    if r != b * num_beams or not 0 <= pos < lmax:
        raise ValueError(f"mla_attention: {r} rows of {b} queries x "
                         f"{num_beams} beams, pos {pos} of {lmax}")
    if q.device.type == "cpu":
        return mla_attention_plain(q, kva, kvb, pk, pv, bias, lens, ck, cv,
                                   pos, inv_freq, num_beams, scale=scale,
                                   rotate=rotate)
    if q.device.type != "cuda":
        raise ValueError(f"mla_attention: tensors on {q.device}, expected "
                         f"cpu or cuda")
    floats = (q, kva, kvb, pk, pv, bias, ck, cv, inv_freq)
    if any(t.dtype != torch.float32 for t in floats) \
            or lens.dtype != torch.int32:
        raise TypeError("mla_attention: the CUDA kernel serves float32 "
                        "tensors and int32 lengths")
    for t in floats + (lens,):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("mla_attention: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    if (dk - rp, rp, dv) != (128, 64, 128) or s > MAX_PREFIX \
            or lmax > MAX_STEPS or rank % 4:
        raise ValueError(f"mla_attention: heads of nope {dk - rp}, rope {rp},"
                         f" v {dv} (the kernel takes 128 / 64 / 128) over "
                         f"{s} prefix positions (at most {MAX_PREFIX}) and "
                         f"{lmax} steps (at most {MAX_STEPS})")
    out = torch.empty((r, h * dv), dtype=torch.float32, device=q.device)
    lib = _lib()
    build.check(lib, lib.gdr_mla_decode(
        q.data_ptr(), kva.data_ptr(), kvb.data_ptr(), pk.data_ptr(),
        pv.data_ptr(), bias.data_ptr(), lens.data_ptr(), ck.data_ptr(),
        cv.data_ptr(), inv_freq.data_ptr(), out.data_ptr(), b, num_beams, h,
        s, lmax, pos, rank, scale, int(rotate),
        torch.cuda.current_stream(q.device).cuda_stream), "mla_attention")
    count("mla_attention")
    return out
