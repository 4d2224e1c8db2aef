"""Decoder-sublayer kernels for the beam-decode loop, with their plain
PyTorch versions.

Replaces the three Pallas kernels of ``gdr_tpu/ops/pallas/decode_kernel.py``:

- :func:`self_attn_sublayer` (``self_attn_sublayer``, core
  ``_cached_self_attention``): RMSNorm → fused QKV → write this step's K/V
  row at ``pos`` in place → causal attention over positions ≤ pos with the
  rel-bias row, no 1/√d, f32 softmax, probs rounded to the model dtype →
  Wo → residual.
- :func:`cross_attn_sublayer` (``cross_attn_sublayer``): RMSNorm → Q → each
  query's beam rows attend over that query's encoder K/V (never copied per
  beam); bias = rel-bias row + −1e9 at pads, *added* as the TPU kernel adds
  it → Wo → residual.
- :func:`ffn_sublayer` (``ffn_sublayer``): RMSNorm → wi → ReLU → wo →
  residual.

**The device decides.**  For a tensor on the CPU a wrapper runs the plain
version; for a CUDA tensor it launches the kernels of
``csrc/decode_sublayers.cu`` or raises.  There is no switch and no
fallback.  The wrappers count the calls that launched kernels
(``WRAPPERS``, in ``utils/timing.py``'s registry).

**Rounding points** are the TPU kernel's (``decode_kernel.py:105-119``,
``:151-154``, ``:193-212``, ``:306-326``, ``:389-393``): the RMSNorm output,
q/k/v, the probabilities, the attention output, the FFN hidden (ReLU in
f32) and each projection's output are rounded to the model dtype; every
product accumulates in f32; scores and softmax are f32.

**What bounds them on the H100, and the design.**  At the full-width step
(R = 3,200 rows of t5-base) the FFN does 30.2 GFLOP on 19.3 MB and the
attention projections 15.1 + 7.9 GFLOP: above the card's ~295 bf16
FLOP/byte ridge, so the tensor cores bound them; at R = 32 the weight bytes
do.  On the TPU each sublayer was one program with all weights in 16 MB
VMEM; a Hopper block has 227 KB, so weights stream through shared memory
and a sublayer is up to three launches of one shared GEMM (:func:`gemm`:
bf16 on ``wgmma`` with TMA-fed shared-memory rings, persistent blocks and
a per-shape plan of tile and split-K (:func:`gemm_plan`); f32 on the FMA
units, exact f32 products with no TF32, above 128 rows from a
warp-specialised, persistent ring (a TMA producer warpgroup, consumer warps
of 8 × 12 outputs a lane, every block an even share of the k-tiles, a
tile's k-range cut across blocks and summed in k order), up to 128 rows
from a small-row kernel that streams W once in strips split over a
cluster's blocks and sums split-K on chip, each by a plan of its own; both
after a row kernel that writes the RMSNorm output once; round / ReLU /
residual epilogue) and, for the attention sublayers, one attention core
between two GEMMs.  Each intermediate is written once in the model dtype,
exactly where the TPU kernel rounds it.  The attention cores are bound by
bytes: the self-attention core reads the [L, R, inner] caches once with
16-byte loads (d_kv / 8 lanes per row and head in bf16; up to 16 positions
every cache row in flight in registers before the reductions, above that
chunks of 16 positions with the scores in shared memory,
:func:`self_attn_max_len`);
the bf16 cross-attention core stages one query's [S, d_kv] K/V in shared
memory once per (query, head) block and runs Q·Kᵀ and P·V of all that
query's beam rows on ``mma.sync`` tensor cores; the f32 core streams the
K/V of a query with fewer than 4 beams (query generation: one) through
lane groups with 16-byte loads, every warp of a block on its keys, and
for more beams stages K/V per (query, head, 32 beams) with 16-byte copies
and runs Q·Kᵀ and P·V as register-tiled FMA products.

Weights are passed in ``nn.Linear`` layout ``[out, in]`` (the transpose of
the TPU kernel's ``[in, out]``): ``wqkv [3·inner, d]``, ``wo [d, inner]``,
``wcq [inner, d]``, ``wco [d, inner]``, ``wi [f, d]``, ``wo [d, f]``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gdr_tpu_torch.kernels import build
from gdr_tpu_torch.utils.timing import count, declare

NEG_INF = -1.0e9
REGISTER_L = 16     # cache positions the self-attention core keeps in registers

WRAPPERS = declare("self_attn_sublayer", "cross_attn_sublayer",
                   "ffn_sublayer")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    # dtype, a, scale, normed, w, resid, c, m, n, k, norm, epi, eps,
    # wg, bn, splits, blocks, stages, kernel, workspace, counters, n_counters,
    # stream
    "gdr_gemm": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                 _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # dtype, m, n, k, sms, int plan[7]
    "gdr_gemm_plan": [_I, _I, _I, _I, _I, _P],
    # m, n, k, sms, int plans[5 * cap], cap, int *count
    "gdr_gemm_ws_plans": [_I, _I, _I, _I, _P, _I, _P],
    # m, n, k, bm, bn, splits, blocks, sms, double model[4] or null, double *s
    "gdr_gemm_ws_time": [_I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # m, n, k, bn, cluster, stages, sms, double model[5] or null, double *s
    "gdr_gemm_rows_time": [_I, _I, _I, _I, _I, _I, _I, _P, _P],
    # dtype, qkv, ck, cv, bias, attn, rows, L, heads, d_kv, pos, stream
    "gdr_self_attn_core": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, q, ck, cv, bias, out, batch, beams, heads, S, d_kv, stream
    "gdr_cross_attn_core": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
EPI_ROUND, EPI_RELU, EPI_RESIDUAL = 0, 1, 2
_EPIS = {"round": EPI_ROUND, "relu": EPI_RELU, "residual": EPI_RESIDUAL}
# shared memory a Hopper block may opt into
_SMEM_OPTIN = 227 * 1024
# head widths of the cross-attention cores (one instantiation each)
_CROSS_DKV = (16, 32, 64, 128)
# the f32 many-beam core's tiles (kBeamTile, kKeyTile in the source)
_CROSS_F32_BEAMS, _CROSS_F32_KEYS = 32, 64
# output tiles a split-K launch may count on (kSplitTiles in the source)
_SPLIT_TILES = 1024
# the most rows the f32 small-row kernel takes (kRowsMaxM in the source)
ROWS_MAX_M = 128


def self_attn_max_len(d_kv: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The longest self-attention cache the CUDA core serves in ``dtype``.
    Up to :data:`REGISTER_L` positions it holds the cache rows in registers;
    above, each of a 128-thread block's (row, head) groups (d_kv·bytes / 16
    lanes each) keeps one f32 score per position in shared memory: 3,632
    positions at d_kv 64 in bf16, 7,264 in f32.  The plain version (CPU) has
    no such limit."""
    lanes = d_kv * torch.finfo(dtype).bits // 8 // 16
    return _SMEM_OPTIN // (4 * (128 // max(lanes, 1)))


def cross_attn_max_len(d_kv: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The longest encoder sequence the CUDA cross-attention core serves in
    ``dtype``.  bf16: the query's K and V rows (d_kv + 8 bf16 each, keys
    padded to 16) and its f32 bias row fit 227 KB of shared memory, 784
    tokens at d_kv 64.  f32: the many-beam core's shared memory holds 32
    q rows, one 64-key tile each of K and V (rows of d_kv + 4 floats) and
    the 32 beams' scores of every key (keys padded to 64, rows + 4), 1,472
    tokens at d_kv 64 (the few-beam core keeps only one score a key).  The
    plain version (CPU) has no such limit."""
    if dtype == torch.bfloat16:
        per_key = 2 * (d_kv + 8) * 2 + 4
        return _SMEM_OPTIN // per_key // 16 * 16
    fixed = (_CROSS_F32_BEAMS + 2 * _CROSS_F32_KEYS) * (d_kv + 4) \
        + _CROSS_F32_BEAMS * 4
    keys = (_SMEM_OPTIN // 4 - fixed) // _CROSS_F32_BEAMS
    return keys // _CROSS_F32_KEYS * _CROSS_F32_KEYS


# ------------------------------------------------------------ plain versions

def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """T5 RMSNorm as the TPU kernel's ``_rms``: f32 mean-square, x·rsqrt,
    ×scale in f32, rounded to the model dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [R, K] · w[N, K]ᵀ with exact products and f32 accumulation."""
    return a.float() @ w.float().t()


def _softmax_last(s: torch.Tensor) -> torch.Tensor:
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(-1, keepdim=True)


def self_attn_sublayer_plain(x, pos: int, ln_scale, wqkv, wo, bias_row, ck,
                             cv, *, heads: int, d_kv: int, eps: float = 1e-6):
    r = x.shape[0]
    lmax = ck.shape[0]
    inner = heads * d_kv
    qkv = _mm(_rms(x, ln_scale, eps), wqkv)
    q = qkv[:, :inner].to(x.dtype)
    ck[pos] = qkv[:, inner:2 * inner].to(ck.dtype)      # in place, as the
    cv[pos] = qkv[:, 2 * inner:].to(cv.dtype)           # kernel writes it
    kf = ck.float().view(lmax, r, heads, d_kv)
    s = torch.einsum("rhd,lrhd->rhl", q.float().view(r, heads, d_kv), kf)
    s = s + bias_row.float().t()[None]                  # [1, H, L]
    causal = torch.arange(lmax, device=x.device) <= pos
    s = torch.where(causal, s, torch.full_like(s, NEG_INF))
    p = _softmax_last(s).to(x.dtype).float()
    vf = cv.float().view(lmax, r, heads, d_kv)
    attn = torch.einsum("rhl,lrhd->rhd", p, vf).to(x.dtype).reshape(r, inner)
    return x + _mm(attn, wo).to(x.dtype), ck, cv


def cross_attn_sublayer_plain(x, ln_scale, wcq, wco, cross_k, cross_v, bias,
                              num_beams: int, *, heads: int, d_kv: int,
                              eps: float = 1e-6):
    r = x.shape[0]
    b = cross_k.shape[0]
    q = _mm(_rms(x, ln_scale, eps), wcq).to(x.dtype)
    qf = q.float().view(b, num_beams, heads, d_kv)
    s = torch.einsum("bkhd,bhsd->bkhs", qf, cross_k.float())
    s = s + bias.float()[:, None]                       # [B, 1, H, S]
    p = _softmax_last(s).to(x.dtype).float()
    o = torch.einsum("bkhs,bhsd->bkhd", p, cross_v.float())
    o = o.to(x.dtype).reshape(r, heads * d_kv)
    return x + _mm(o, wco).to(x.dtype)


def ffn_sublayer_plain(x, ln_scale, wi, wo, *, eps: float = 1e-6):
    h = torch.relu(_mm(_rms(x, ln_scale, eps), wi)).to(x.dtype)
    return x + _mm(h, wo).to(x.dtype)


def gemm_plain(a, w, epi: str, *, scale=None, resid=None, eps: float = 1e-6):
    """The sublayers' GEMM step: ``round(norm(a) · wᵀ)``, ``round(relu(...))``
    or ``resid + round(a · wᵀ)``, in the model dtype."""
    if epi == "residual":
        return resid + _mm(a, w).to(a.dtype)
    y = _mm(_rms(a, scale, eps), w)
    return (torch.relu(y) if epi == "relu" else y).to(a.dtype)


# --------------------------------------------------------------- wrappers

def _lib():
    return build.load("decode_sublayers", _SIGS)


def _check_cuda(name: str, dtype: torch.dtype, *tensors, bias) -> int:
    """Device, dtype and contiguity of the model-dtype ``tensors``; the
    attention ``bias`` (any float dtype, made f32 by the caller) is held to
    the same device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected cpu or cuda")
    if dtype not in build.FLOAT_DTYPES:
        raise TypeError(f"{name}: model dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in (*tensors, *(() if bias is None else (bias,))):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: a {t.dtype} tensor among {dtype} ones")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(t.shape)}")
    return build.DTYPES[dtype]


def _shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# GemmPlan.kernel, csrc's Kernel: the bf16 tile kernel, the f32 small-row
# kernel, the f32 warp-specialised ring
KERNEL_WGMMA, KERNEL_ROWS, KERNEL_WS = 0, 1, 2


class GemmPlan(NamedTuple):
    """A launch of the GEMM (``gdr_gemm_plan``): tiles of :attr:`rows` ×
    ``bn`` columns fed by a ring of ``stages`` k-tiles; each output tile's
    k-tiles split ``splits`` ways; ``units`` = tiles · splits work units.
    ``kernel`` :data:`KERNEL_WGMMA` (bf16): 64·``wg`` rows, one consumer
    warpgroup per 64, the units walked by ``blocks`` persistent blocks (at
    most one per SM).  :data:`KERNEL_WS` (f32): the warp-specialised ring,
    tiles of 32·``wg`` rows (128 × 96 or 64 × 192), each tile's 32-float
    k-tiles cut into ``splits`` units, the units dealt to ``blocks``
    persistent blocks in even contiguous ranges (a tile's k-range may be cut
    across blocks).  :data:`KERNEL_ROWS` (f32, M <= :data:`ROWS_MAX_M`): the
    small-row kernel, one tile of all M rows padded to 8·``wg``
    (``csrc``'s rows_pad: to 8 up to 64 rows, to 16 above) and strips of
    ``bn`` (48 or 64) columns, each strip's k-tiles split over the
    ``splits`` (1-8) blocks of a cluster and summed on chip; a ring of
    ``stages`` (1-8) 32-float k-tiles; no workspace."""
    wg: int
    bn: int
    stages: int
    splits: int
    units: int
    blocks: int
    kernel: int = KERNEL_WGMMA

    @property
    def f32(self) -> bool:
        return self.kernel != KERNEL_WGMMA

    @property
    def rows(self) -> int:
        return {KERNEL_WGMMA: 64, KERNEL_ROWS: 8, KERNEL_WS: 32}[self.kernel] * self.wg

    def workspace(self, m: int, n: int) -> int:
        """f32 elements of the split partials at C [m, n]: per output tile
        and split for the bf16 tile kernel, two tiles a block for the
        warp-specialised ring (a block's first and last run); 0 unsplit, and
        0 for the small-row kernel, which sums its splits on chip."""
        if self.splits == 1 or self.kernel == KERNEL_ROWS:
            return 0
        bm = self.rows
        if self.kernel == KERNEL_WS:
            return 2 * self.blocks * bm * self.bn
        return -(-m // bm) * -(-n // self.bn) * self.splits * bm * self.bn


def rows_pad(m: int) -> int:
    """The small-row kernel's row extent at M rows: M padded to 8 up to 64
    rows, to 16 above (``rows_pad`` in the source)."""
    return -(-m // 8) * 8 if m <= 64 else -(-m // 16) * 16


def rows_plan(m: int, n: int, bn: int = 64, splits: int = 1,
              stages: int = 4) -> GemmPlan:
    """A plan of the f32 small-row kernel at C [m, n]: strips of ``bn``
    columns, each split over a cluster of ``splits`` blocks, a ring of
    ``stages`` k-tiles."""
    units = -(-n // bn) * splits
    return GemmPlan(rows_pad(m) // 8, bn, stages, splits, units, units,
                    KERNEL_ROWS)


def ws_plan(m: int, n: int, k: int, rows: int = 128, bn: int = 96,
            splits: int | None = None, blocks: int = 132,
            stages: int = 3) -> GemmPlan:
    """A plan of the warp-specialised f32 ring at C [m, n], K = k: tiles of
    ``rows`` × ``bn``, each tile's 32-float k-tiles cut into ``splits``
    units (default: one a k-tile), dealt to ``blocks`` blocks, a ring of
    ``stages``."""
    splits = -(-k // 32) if splits is None else splits
    units = -(-m // rows) * -(-n // bn) * splits
    return GemmPlan(rows // 32, bn, stages, splits, units, blocks, KERNEL_WS)


_PLANS: dict = {}
_COUNTERS: dict = {}


def gemm_plan(m: int, n: int, k: int, device=None,
              dtype: torch.dtype = torch.bfloat16) -> GemmPlan:
    """The cost model's plan for the GEMM C[m, n] = A[m, k] · W[n, k]ᵀ in
    ``dtype`` (bf16 or f32, each its own model) on a CUDA device, cached per
    device, dtype and shape."""
    dev = torch.device("cuda" if device is None else device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (idx, dtype, m, n, k)
    plan = _PLANS.get(key)
    if plan is None:
        lib = _lib()
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        out = (ctypes.c_int * 7)()
        build.check(lib, lib.gdr_gemm_plan(build.DTYPES[dtype], m, n, k, sms,
                                           ctypes.addressof(out)),
                    "gemm_plan")
        plan = _PLANS[key] = GemmPlan(*out)
    return plan


def _counters(device: torch.device) -> torch.Tensor:
    """The device's split-K arrival counters: zeroed once, and left zero by
    every launch (the last split of a tile resets its counter).  Split
    launches on one device share them, so they run in stream order, as the
    port's decoder does."""
    buf = _COUNTERS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("gemm: the first split-K launch on a device "
                               "runs outside CUDA graph capture (it zeroes "
                               "the arrival counters)")
        buf = _COUNTERS[device] = torch.zeros(_SPLIT_TILES, dtype=torch.int32,
                                              device=device)
    return buf


def _gemm(lib, code, a, scale, w, resid, c, epi, eps, stream, what,
          plan: GemmPlan | None = None):
    """One launch of ``gdr_gemm``: RMSNorm (into a ``normed`` scratch) +
    round / ReLU, or residual.  It runs ``plan`` (the dtype's cost model's
    by default) with its split workspace from the caching allocator."""
    m, k = a.shape
    n = w.shape[0]
    norm = epi != EPI_RESIDUAL
    # TMA and the 16-byte row chunks need widths that are multiples of 8
    # and 16-byte aligned tensors
    if n % 8 or k % 8 or any(t.data_ptr() % 16 for t in (a, scale, w, resid, c)
                             if t is not None):
        raise ValueError(f"{what}: needs widths that are multiples of 8 and "
                         f"16-byte aligned tensors (m={m}, n={n}, k={k})")
    normed = torch.empty_like(a) if norm else None
    ws = counters = None
    plan = plan or gemm_plan(m, n, k, a.device, a.dtype)
    if plan.f32 != (a.dtype == torch.float32):
        raise ValueError(f"{what}: a {'f32' if plan.f32 else 'bf16'} plan for "
                         f"{a.dtype} operands")
    if plan.workspace(m, n):
        ws = torch.empty(plan.workspace(m, n), dtype=torch.float32,
                         device=a.device)
        counters = _counters(a.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    build.check(lib, lib.gdr_gemm(
        code, a.data_ptr(), scale.data_ptr() if norm else None, ptr(normed),
        w.data_ptr(), ptr(resid), c.data_ptr(), m, n, k, int(norm), epi, eps,
        plan.wg, plan.bn, plan.splits, plan.blocks, plan.stages,
        plan.kernel, ptr(ws), ptr(counters), _SPLIT_TILES,
        stream), what)


def gemm(a, w, epi: str, *, scale=None, resid=None, eps: float = 1e-6,
         plan: GemmPlan | None = None):
    """The decoder sublayers' GEMM on its own: a [M, K], w [N, K];
    ``epi`` "round" or "relu" (RMSNorm of ``a`` with ``scale`` first) or
    "residual" (``resid`` [M, N] + the rounded product).  ``plan`` replaces
    the cost model's plan (in bf16 any instantiated tile, 1 <= splits <=
    min(k-tiles, 32), any number of blocks; in f32 a plan of the
    warp-specialised ring, 1 <= splits <= its 32-float k-tiles, 1-8 stages,
    any number of blocks, or, at M <= 128, a plan of the small-row kernel,
    which refuses more rows).  The sublayer
    wrappers count their launches; this entry point, for tests and
    per-shape timing, counts none."""
    if epi not in _EPIS or (epi == "residual") != (scale is None) or (
            epi == "residual") != (resid is not None):
        raise ValueError(f"gemm: epi {epi!r} takes scale for round/relu and "
                         f"resid for residual")
    if a.device.type == "cpu":
        return gemm_plain(a, w, epi, scale=scale, resid=resid, eps=eps)
    code = _check_cuda("gemm", a.dtype, *(t for t in (a, w, scale, resid)
                                          if t is not None), bias=None)
    if a.dim() != 2 or w.dim() != 2 or w.shape[1] != a.shape[1]:
        raise ValueError(f"gemm: a {tuple(a.shape)}, w {tuple(w.shape)}")
    c = torch.empty((a.shape[0], w.shape[0]), dtype=a.dtype, device=a.device)
    if resid is not None:
        _shape("gemm resid", resid, tuple(c.shape))
    if scale is not None:
        _shape("gemm scale", scale, (a.shape[1],))
    _gemm(_lib(), code, a, scale, w, resid, c, _EPIS[epi], eps, _stream(a),
          "gemm", plan)
    return c


def _check_heads(name: str, dtype: torch.dtype, d_kv: int, cross: bool):
    """The head widths the attention cores take: one of _CROSS_DKV for the
    cross-attention cores, and a power-of-two number of 16-byte chunks, at
    most 32, for the self-attention core (one lane a chunk)."""
    if cross:
        ok = d_kv in _CROSS_DKV
    else:
        chunks, rem = divmod(d_kv * torch.finfo(dtype).bits // 8, 16)
        ok = rem == 0 and 0 < chunks <= 32 and chunks & (chunks - 1) == 0
    if not ok:
        raise ValueError(f"{name}: d_kv {d_kv} not served by the CUDA core in "
                         f"{dtype}")


def self_attn_sublayer(x, pos: int, ln_scale, wqkv, wo, bias_row, ck, cv,
                       *, heads: int, d_kv: int, eps: float = 1e-6):
    """x: [R, d]; pos: this step's position; ln_scale: [d];
    wqkv: [3·inner, d]; wo: [d, inner]; bias_row: [L, H] f32 (rel bias of
    query position ``pos``); ck/cv: [L, R, inner], written at ``pos`` in
    place.  Returns (x', ck, cv)."""
    if x.device.type == "cpu":
        return self_attn_sublayer_plain(x, pos, ln_scale, wqkv, wo, bias_row,
                                        ck, cv, heads=heads, d_kv=d_kv,
                                        eps=eps)
    code = _check_cuda("self_attn_sublayer", x.dtype, x, ln_scale, wqkv, wo,
                       ck, cv, bias=bias_row)
    r, d = x.shape
    lmax = ck.shape[0]
    inner = heads * d_kv
    _shape("self_attn_sublayer wqkv", wqkv, (3 * inner, d))
    _shape("self_attn_sublayer wo", wo, (d, inner))
    _shape("self_attn_sublayer ck", ck, (lmax, r, inner))
    _shape("self_attn_sublayer cv", cv, (lmax, r, inner))
    _shape("self_attn_sublayer bias_row", bias_row, (lmax, heads))
    _check_heads("self_attn_sublayer", x.dtype, d_kv, cross=False)
    limit = self_attn_max_len(d_kv, x.dtype)
    if not 0 <= pos < lmax or lmax > limit:
        raise ValueError(f"self_attn_sublayer: pos {pos} / L {lmax} outside "
                         f"0 <= pos < L <= {limit} (d_kv {d_kv}, {x.dtype})")
    lib = _lib()
    stream = _stream(x)
    bias = bias_row.to(torch.float32).contiguous()
    qkv = torch.empty((r, 3 * inner), dtype=x.dtype, device=x.device)
    attn = torch.empty((r, inner), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _gemm(lib, code, x, ln_scale, wqkv, None, qkv, EPI_ROUND, eps, stream,
          "self_attn_sublayer qkv")
    build.check(lib, lib.gdr_self_attn_core(
        code, qkv.data_ptr(), ck.data_ptr(), cv.data_ptr(), bias.data_ptr(),
        attn.data_ptr(), r, lmax, heads, d_kv, pos, stream),
        "self_attn_sublayer core")
    _gemm(lib, code, attn, None, wo, x, out, EPI_RESIDUAL, eps, stream,
          "self_attn_sublayer wo")
    count("self_attn_sublayer")
    return out, ck, cv


def cross_attn_sublayer(x, ln_scale, wcq, wco, cross_k, cross_v, bias,
                        num_beams: int, *, heads: int, d_kv: int,
                        eps: float = 1e-6):
    """x: [B·K, d] (rows b·K … b·K+K-1 belong to query b); wcq: [inner, d];
    wco: [d, inner]; cross_k/v: [B, H, S, d_kv] per query; bias: [B, H, S]
    f32 — rel-bias row + −1e9 at pads."""
    if x.device.type == "cpu":
        return cross_attn_sublayer_plain(x, ln_scale, wcq, wco, cross_k,
                                         cross_v, bias, num_beams,
                                         heads=heads, d_kv=d_kv, eps=eps)
    code = _check_cuda("cross_attn_sublayer", x.dtype, x, ln_scale, wcq, wco,
                       cross_k, cross_v, bias=bias)
    r, d = x.shape
    b, h_, s_, dk = cross_k.shape
    inner = heads * d_kv
    if r != b * num_beams or h_ != heads or dk != d_kv:
        raise ValueError(f"cross_attn_sublayer: x {tuple(x.shape)}, cross_k "
                         f"{tuple(cross_k.shape)}, beams {num_beams}")
    _check_heads("cross_attn_sublayer", x.dtype, d_kv, cross=True)
    if s_ > cross_attn_max_len(d_kv, x.dtype):
        raise ValueError(f"cross_attn_sublayer: {s_} encoder positions; the "
                         f"CUDA kernel serves at most "
                         f"{cross_attn_max_len(d_kv, x.dtype)} at d_kv {d_kv} "
                         f"in {x.dtype}")
    _shape("cross_attn_sublayer wcq", wcq, (inner, d))
    _shape("cross_attn_sublayer wco", wco, (d, inner))
    _shape("cross_attn_sublayer cross_v", cross_v, (b, heads, s_, d_kv))
    _shape("cross_attn_sublayer bias", bias, (b, heads, s_))
    lib = _lib()
    stream = _stream(x)
    bias = bias.to(torch.float32).contiguous()
    q = torch.empty((r, inner), dtype=x.dtype, device=x.device)
    o = torch.empty((r, inner), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _gemm(lib, code, x, ln_scale, wcq, None, q, EPI_ROUND, eps, stream,
          "cross_attn_sublayer q")
    build.check(lib, lib.gdr_cross_attn_core(
        code, q.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
        bias.data_ptr(), o.data_ptr(), b, num_beams, heads, s_, d_kv, stream),
        "cross_attn_sublayer core")
    _gemm(lib, code, o, None, wco, x, out, EPI_RESIDUAL, eps, stream,
          "cross_attn_sublayer wo")
    count("cross_attn_sublayer")
    return out


def ffn_sublayer(x, ln_scale, wi, wo, *, eps: float = 1e-6):
    """x: [R, d]; wi: [f, d]; wo: [d, f].  RMSNorm → wi → ReLU → wo →
    residual."""
    if x.device.type == "cpu":
        return ffn_sublayer_plain(x, ln_scale, wi, wo, eps=eps)
    code = _check_cuda("ffn_sublayer", x.dtype, x, ln_scale, wi, wo,
                       bias=None)
    r, d = x.shape
    f = wi.shape[0]
    _shape("ffn_sublayer wi", wi, (f, d))
    _shape("ffn_sublayer wo", wo, (d, f))
    lib = _lib()
    stream = _stream(x)
    h = torch.empty((r, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _gemm(lib, code, x, ln_scale, wi, None, h, EPI_RELU, eps, stream,
          "ffn_sublayer wi")
    _gemm(lib, code, h, None, wo, x, out, EPI_RESIDUAL, eps, stream,
          "ffn_sublayer wo")
    count("ffn_sublayer")
    return out
