"""Kimi Delta Attention (KDA, the gated delta rule of Kimi Linear) over a
query's prefix and for one decode step of its beam rows, with the plain
PyTorch versions, in f32.

A KDA layer (``models/kimi_linear.py``) hands in, per token row, the raw
products of its normed input h:

- ``qkv`` [R, 3·H·K]: W_{q,k,v} h, before the convolution (q's H·K
  columns, then k's, then v's; K = V = the head dim);
- ``fgb`` [R, 2·K + H]: W_fa h (K), W_ga h (K) and W_b h (H), the gate's
  and the output gate's low-rank down projections and β's logits;

and the layer's ``w_fb`` [H·K, K], ``w_gb`` [H·V, K] (the up projections),
``conv_w`` [3·H·K, T] (depthwise taps, the last on the current token),
``a_log`` [H], ``dt_bias`` [H·K] and ``norm_w`` [V].  Per token and head
(arXiv:2510.26692; the ``fla`` library's ``KimiDeltaAttention``):

    q, k, v = SiLU(causal depthwise conv_T(qkv))        (a head's K columns)
    q = q / sqrt(Σq² + 1e-6) · K^-½;   k = k / sqrt(Σk² + 1e-6)
    g = −exp(a_log[h]) · softplus(W_fb W_fa h + dt_bias)  (per channel of K)
    β = sigmoid(W_b h)[h]
    S ← diag(exp g) S;   S ← S + β k (vᵀ − kᵀS);   o = Sᵀq     (S [K, V])
    o ← RMSNorm_eps(o) ⊙ norm_w ⊙ sigmoid(W_gb W_ga h)

:func:`kda_prefill` runs the query's real tokens (``lens``; pads follow
them, are never entered into the recurrence and give o = 0) from a zero
state and an empty window, and returns each query's state [B, H, K, V]
and convolution window [B, T − 1, 3·H·K] (the raw inputs of its last T − 1
real tokens, zero before the first) after its last real token.

:func:`kda_decode` takes one token a beam row.  Each row reads the state
and window of its **source row** — ``src`` [R] int32, the beam search's
step source, or, without it, row r·n / R of the n input rows (the query's
prefix at step 0, the row itself for a constant width) — and writes its
new state and window to row r of ``state_out`` / ``conv_out``, which are
not the inputs (two buffers a layer, alternating by step): the beams'
reorder is the state's one read and write, not a gather of its own.

**The device decides.**  A CPU tensor runs the plain version; a CUDA
tensor launches ``gdr::kda_prefill`` / ``gdr::kda_decode``
(``csrc/kda.cu``), f32 only, at head dim 128.  The grids depend on the
shapes alone, so a decode call captures in a CUDA graph.  The wrappers
count their launches (``WRAPPERS``) and the host counter
``kda_state_rows`` the beam rows whose state a decode call wrote (on
either device).  Two counters live on the device (``STATS``), added to by
the kernels themselves (by the wrappers on the CPU), so graph replays
count too: ``kda_source_rows``, the distinct source rows a decode call
read (each state and window is read once however many rows continue it),
and ``kda_prefill_tokens``, the real tokens the prefills ran;
``kernels.launch_counts(experts=True)`` reads them beside the experts'
routing counters.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gdr_tpu_torch.kernels import build
from gdr_tpu_torch.utils.timing import count, declare

WRAPPERS = declare("kda_prefill", "kda_decode")
declare("kda_state_rows")
STATS = ("kda_source_rows", "kda_prefill_tokens")
_STATS: dict[torch.device, torch.Tensor] = {}
L2_EPS = 1e-6           # fla's l2norm inside its KDA kernels
HEAD_DIM = 128          # the kernels' K = V (kKdaK in the source)
MAX_SEQ = 64            # query tokens a prefill block stages

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    # qkv, fgb, w_fb, w_gb, conv_w, a_log, dt_bias, norm_w, lens, out,
    # state, conv, stats, B, S, H, T, eps, stream
    "gdr_kda_prefill": [_P] * 13 + [_I] * 4 + [_F, _P],
    # qkv, fgb, w_fb, w_gb, conv_w, a_log, dt_bias, norm_w, state_in,
    # conv_in, src, state_out, conv_out, out, stats, R, n_in, H, T, eps,
    # stream
    "gdr_kda_decode": [_P] * 15 + [_I] * 4 + [_F, _P],
}


def stats_tensor(device: torch.device) -> torch.Tensor:
    """The device counters [2] int64 of ``device``, made (zero) at the
    first use, which may not be under graph capture."""
    t = _STATS.get(device)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("kda: the first call on a device runs outside "
                               "CUDA graph capture (it makes the counters)")
        t = _STATS[device] = torch.zeros(len(STATS), dtype=torch.int64,
                                         device=device)
    return t


def read_stats() -> dict[str, int]:
    """The device counters summed over devices (one sync each)."""
    total = [0] * len(STATS)
    for t in _STATS.values():
        total = [a + b for a, b in zip(total, t.tolist())]
    return dict(zip(STATS, total))


def reset_stats() -> None:
    for t in _STATS.values():
        t.zero_()


# ------------------------------------------------------------ plain versions

def _gates(fgb, w_fb, w_gb, a_log, dt_bias, heads: int):
    """(log-decay g [R, H, K], β [R, H], output gate [R, H, V]) of rows
    ``fgb``."""
    r = fgb.shape[0]
    dk = w_fb.shape[1]
    f = fgb[:, :dk].float() @ w_fb.float().t()
    og = fgb[:, dk:2 * dk].float() @ w_gb.float().t()
    g = -torch.exp(a_log.float())[:, None] * F.softplus(
        (f + dt_bias.float()).view(r, heads, -1))
    beta = torch.sigmoid(fgb[:, 2 * dk:].float())
    return g, beta, og.view(r, heads, -1)


def _qkv(full, conv_w, heads: int):
    """q (normed, scaled), k (normed), v [R, H, K] of the windows ``full``
    [R, T, 3·H·K] (oldest first, the current token last)."""
    y = F.silu((full.float() * conv_w.float().t()[None]).sum(1))
    r = y.shape[0]
    q, k, v = (t.reshape(r, heads, -1) for t in y.chunk(3, dim=1))
    dk = q.shape[-1]
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + L2_EPS) * dk ** -0.5
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + L2_EPS)
    return q, k, v


def _delta(s, q, k, v, g, beta):
    """One token of the recurrence for states s [R, H, K, V]: (o [R, H,
    V], the new states)."""
    s = s * torch.exp(g)[..., None]
    u = torch.einsum("rhk,rhkv->rhv", k, s)
    s = s + (beta[..., None] * k)[..., None] * (v - u)[:, :, None, :]
    return torch.einsum("rhk,rhkv->rhv", q, s), s


def _gated_norm(o, og, norm_w, eps: float):
    o = o * torch.rsqrt((o * o).mean(-1, keepdim=True) + eps)
    return o * norm_w.float() * torch.sigmoid(og)


def kda_prefill_plain(qkv, fgb, w_fb, w_gb, conv_w, a_log, dt_bias, norm_w,
                      lens, *, batch: int, heads: int, eps: float):
    n, c = qkv.shape
    s = n // batch
    t = conv_w.shape[1]
    dv = w_gb.shape[0] // heads
    x = qkv.float().view(batch, s, c)
    pad = torch.cat([x.new_zeros((batch, t - 1, c)), x], dim=1)
    full = torch.stack([pad[:, j:j + s] for j in range(t)], dim=2)
    q, k, v = _qkv(full.view(n, t, c), conv_w, heads)
    g, beta, og = _gates(fgb, w_fb, w_gb, a_log, dt_bias, heads)
    view = lambda z: z.view(batch, s, *z.shape[1:])
    q, k, v, g, beta = map(view, (q, k, v, g, beta))
    state = x.new_zeros((batch, heads, k.shape[-1], dv))
    o = x.new_zeros((batch, s, heads, dv))
    live = torch.arange(s, device=x.device)[None] < lens.long()[:, None]
    for j in range(s):
        oj, sj = _delta(state, q[:, j], k[:, j], v[:, j], g[:, j],
                        beta[:, j])
        m = live[:, j]
        state = torch.where(m[:, None, None, None], sj, state)
        o[:, j] = torch.where(m[:, None, None], oj, 0.0)
    o = _gated_norm(o.view(n, heads, dv), og, norm_w, eps)
    o = torch.where(live.reshape(n)[:, None, None], o, 0.0)
    last = lens.long()[:, None] + torch.arange(-(t - 1), 0,
                                               device=x.device)[None]
    conv = pad.gather(1, (last + t - 1)[..., None].expand(-1, -1, c))
    return (o.reshape(n, heads * dv).to(qkv.dtype), state.to(qkv.dtype),
            conv.to(qkv.dtype))


def source_rows(src, rows: int, n_in: int, device) -> torch.Tensor:
    """The input row each of ``rows`` rows reads: ``src``, or r·n_in /
    rows."""
    if src is not None:
        return src.long()
    return torch.arange(rows, device=device) * n_in // rows


def kda_decode_plain(qkv, fgb, w_fb, w_gb, conv_w, a_log, dt_bias, norm_w,
                     state_in, conv_in, src, state_out, conv_out, *,
                     heads: int, eps: float):
    r = qkv.shape[0]
    idx = source_rows(src, r, state_in.shape[0], qkv.device)
    full = torch.cat([conv_in[idx].float(), qkv.float()[:, None]], dim=1)
    q, k, v = _qkv(full, conv_w, heads)
    g, beta, og = _gates(fgb, w_fb, w_gb, a_log, dt_bias, heads)
    o, s = _delta(state_in[idx].float(), q, k, v, g, beta)
    state_out.copy_(s.to(state_out.dtype))
    conv_out.copy_(full[:, 1:].to(conv_out.dtype))
    o = _gated_norm(o, og, norm_w, eps)
    return o.reshape(r, -1).to(qkv.dtype)


# --------------------------------------------------------------- wrappers

def _lib():
    return build.load("kda", _SIGS)


def _check(what: str, tensors: dict, shapes: dict, src=None) -> None:
    for name, shape in shapes.items():
        t = tensors[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} {name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
    first = next(iter(tensors.values()))
    if first.device.type == "cpu":
        return
    if first.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {first.device}, expected cpu "
                         f"or cuda")
    ints = {"lens", "src"}
    for name, t in list(tensors.items()) + [("src", src)]:
        if t is None:
            continue
        if t.dtype != (torch.int32 if name in ints else torch.float32):
            raise TypeError(f"{what}: the CUDA kernels serve float32 tensors "
                            f"and int32 indices, not {name} {t.dtype}")
        if t.device != first.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous, 16-byte "
                             f"aligned and on one device")


def _shapes(qkv, fgb, w_fb, conv_w, heads: int) -> tuple[int, int, int]:
    """(head dim, taps, channels) after checking the widths agree."""
    c = qkv.shape[1]
    dk = w_fb.shape[1]
    if c != 3 * heads * dk or fgb.shape[1] != 2 * dk + heads \
            or conv_w.shape[0] != c:
        raise ValueError(f"kda: qkv {tuple(qkv.shape)}, fgb "
                         f"{tuple(fgb.shape)}, conv {tuple(conv_w.shape)} do "
                         f"not make {heads} heads of {dk}")
    return dk, conv_w.shape[1], c


def _served(what: str, dk: int, t: int) -> None:
    if dk != HEAD_DIM or not 1 <= t <= 4:
        raise ValueError(f"{what}: the kernel takes heads of {HEAD_DIM} and "
                         f"1-4 taps, not {dk} / {t}")


def kda_prefill(qkv, fgb, w_fb, w_gb, conv_w, a_log, dt_bias, norm_w, lens,
                *, batch: int, heads: int, eps: float):
    """The KDA layer over B queries' padded rows ``qkv`` [B·S, 3·H·K],
    ``fgb`` [B·S, 2K + H] (``lens`` [B] int32 real tokens, pads after).
    Returns (o [B·S, H·V], states [B, H, K, V], windows [B, T−1, 3·H·K])."""
    n = qkv.shape[0]
    dk, t, c = _shapes(qkv, fgb, w_fb, conv_w, heads)
    if batch <= 0 or n % batch:
        raise ValueError(f"kda_prefill: {n} rows are not {batch} queries")
    s = n // batch
    tensors = dict(qkv=qkv, fgb=fgb, w_fb=w_fb, w_gb=w_gb, conv_w=conv_w,
                   a_log=a_log, dt_bias=dt_bias, norm_w=norm_w, lens=lens)
    _check("kda_prefill", tensors, dict(
        w_gb=(heads * dk, dk), a_log=(heads,), dt_bias=(heads * dk,),
        norm_w=(dk,), lens=(batch,)))
    stats = stats_tensor(qkv.device)
    if qkv.device.type == "cpu":
        stats[1] += int(lens.long().clamp(0, s).sum())
        return kda_prefill_plain(qkv, fgb, w_fb, w_gb, conv_w, a_log,
                                 dt_bias, norm_w, lens, batch=batch,
                                 heads=heads, eps=eps)
    _served("kda_prefill", dk, t)
    if s > MAX_SEQ:
        raise ValueError(f"kda_prefill: {s} positions (at most {MAX_SEQ})")
    dev = qkv.device
    out = torch.empty((n, heads * dk), dtype=torch.float32, device=dev)
    state = torch.empty((batch, heads, dk, dk), dtype=torch.float32,
                        device=dev)
    conv = torch.empty((batch, t - 1, c), dtype=torch.float32, device=dev)
    lib = _lib()
    build.check(lib, lib.gdr_kda_prefill(
        *(x.data_ptr() for x in (qkv, fgb, w_fb, w_gb, conv_w, a_log,
                                 dt_bias, norm_w, lens, out, state)),
        conv.data_ptr() if t > 1 else None, stats.data_ptr(), batch, s,
        heads, t, eps,
        torch.cuda.current_stream(dev).cuda_stream), "kda_prefill")
    count("kda_prefill")
    return out, state, conv


def kda_decode(qkv, fgb, w_fb, w_gb, conv_w, a_log, dt_bias, norm_w,
               state_in, conv_in, src, state_out, conv_out, *, heads: int,
               eps: float):
    """One decode step of R rows (see the module's docstring): reads
    ``state_in`` [n, H, K, V] / ``conv_in`` [n, T−1, 3·H·K] at each row's
    source, writes ``state_out`` [R, H, K, V] / ``conv_out`` [R, T−1,
    3·H·K].  Returns o [R, H·V]."""
    r = qkv.shape[0]
    dk, t, c = _shapes(qkv, fgb, w_fb, conv_w, heads)
    n_in = state_in.shape[0]
    tensors = dict(qkv=qkv, fgb=fgb, w_fb=w_fb, w_gb=w_gb, conv_w=conv_w,
                   a_log=a_log, dt_bias=dt_bias, norm_w=norm_w,
                   state_in=state_in, conv_in=conv_in, state_out=state_out,
                   conv_out=conv_out)
    _check("kda_decode", tensors, dict(
        fgb=(r, 2 * dk + heads), w_gb=(heads * dk, dk), a_log=(heads,),
        dt_bias=(heads * dk,), norm_w=(dk,), state_in=(n_in, heads, dk, dk),
        conv_in=(n_in, t - 1, c), state_out=(r, heads, dk, dk),
        conv_out=(r, t - 1, c)), src)
    if src is None and (n_in <= 0 or r % n_in):
        raise ValueError(f"kda_decode: {r} rows do not share {n_in} sources")
    if src is not None and tuple(src.shape) != (r,):
        raise ValueError(f"kda_decode src: expected shape {(r,)}, got "
                         f"{tuple(src.shape)}")
    if state_out.data_ptr() == state_in.data_ptr():
        raise ValueError("kda_decode: the state is read and written in two "
                         "buffers")
    count("kda_state_rows", r)
    stats = stats_tensor(qkv.device)
    if qkv.device.type == "cpu":
        stats[0] += source_rows(src, r, n_in, qkv.device).unique().numel()
        return kda_decode_plain(qkv, fgb, w_fb, w_gb, conv_w, a_log, dt_bias,
                                norm_w, state_in, conv_in, src, state_out,
                                conv_out, heads=heads, eps=eps)
    _served("kda_decode", dk, t)
    dev = qkv.device
    out = torch.empty((r, heads * dk), dtype=torch.float32, device=dev)
    lib = _lib()
    ptr = lambda x: None if x is None or x.numel() == 0 else x.data_ptr()
    build.check(lib, lib.gdr_kda_decode(
        *(x.data_ptr() for x in (qkv, fgb, w_fb, w_gb, conv_w, a_log,
                                 dt_bias, norm_w, state_in)),
        ptr(conv_in), ptr(src), state_out.data_ptr(), ptr(conv_out),
        out.data_ptr(), stats.data_ptr(), r, n_in, heads, t, eps,
        torch.cuda.current_stream(dev).cuda_stream), "kda_decode")
    count("kda_decode")
    return out
