"""The routed-expert sublayers, their plain PyTorch versions and their
routing counters, in f32:

- :func:`expert_sublayer`, a Switch Transformer's (top-1 routing with a
  capacity, ReLU experts);
- :func:`topk_expert_sublayer`, DeepSeek-V3's (top-k of sigmoid scores
  plus a selection-only bias, SwiGLU experts, no capacity, shared experts
  added by the caller).

:func:`expert_sublayer` computes, for rows x [R, d] that form R / seq_len
sequences of ``seq_len`` tokens (the encoder: a query's tokens; a decode
step: one token a beam row), as ``transformers``'
``SwitchTransformersLayerFF`` with its sparse MLP and ``Top1Router``:

- h = RMSNorm(x); z = h·W_rᵀ in f32 (no bias); e = argmax z (the first of
  equal logits) and π = softmax(z)[e];
- a token is kept if fewer than ``capacity`` earlier tokens of its sequence
  went to e (``counts`` [R / seq_len, E]: tokens of earlier calls, added to
  in place, so that a cached decode counts the beam's whole prefix);
- x' = x + π · W_o[e] ReLU(W_i[e] h), and x' = x for a dropped token.

:func:`topk_expert_sublayer` computes, for rows x [R, d], as
``transformers``' ``DeepseekV3MoE`` with its ``DeepseekV3TopkRouter`` (one
group): h = RMSNorm(x); s = sigmoid(h·W_rᵀ) in f32; the row's k experts
are those of the k largest s + b (``bias``, the score correction; the
lower index first among equals), taken in ascending expert order; their
weights w_j = s_j / (Σ s + 1e-20) · ``scale``; and x' = ``base`` + Σ_j w_j
· W_o[e_j](silu(W_g[e_j] h) ⊙ W_u[e_j] h), the sum in that order, where
``base`` is x plus the shared experts' output, which the caller computes
(``models/deepseek.py``).  An expert's ``wi`` [2·d_ff, d] holds its gate
rows, then its up rows.  **The chip's share**: ``wi`` / ``wo`` may hold
only experts ``offset`` … ``offset + held − 1`` of the router's E (an
expert-parallel deployment's card); the selection and the weights are
over all E as before, and the sum runs over the chosen experts held here,
what the others add being another card's.

**The device decides.**  A CPU tensor runs the plain version, a CUDA
tensor launches the ``gdr::moe_`` kernels of ``csrc/experts.cu`` or
raises; the library is built and loaded at the first CUDA call, so a
dense model never touches it.  Only f32 is served on the card: a bf16
model raises.

**Inside a CUDA graph.**  The launches' grids depend on the shapes alone:
the router and the grouping run on fixed grids, the expert products on
a persistent grid that walks the work list the grouping leaves in device
memory.  Nothing is read back to the host, so a call captures as it runs.

The wrappers count the calls that launched the kernels (``WRAPPERS``, in
``utils/timing.py``'s registry).  The routing counters (``STATS``: calls,
rows, experts hit, the most rows on one expert, the dropped tokens and
the assignments of rows to experts, rows × k, and the top-k path's chunks
of at most 16 assignments of one expert, Σ⌈load / 16⌉, so that
assignments / chunks is the rows a chunk holds, and the assignments that
fell to held experts, ``moe_held``; each summed over calls) live
on the device and are added to by the kernels themselves (by the plain
versions on the CPU), so graph replays count too;
``kernels.launch_counts(experts=True)`` reads them with one sync per device
and ``reset_launch_counts()`` zeroes them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gdr_tpu_torch.kernels import build
from gdr_tpu_torch.kernels.decode import _mm, _rms
from gdr_tpu_torch.utils.timing import count, declare

WRAPPERS = declare("expert_sublayer", "topk_expert_sublayer")
STATS = ("moe_calls", "moe_rows", "moe_experts_hit", "moe_max_load",
         "moe_dropped", "moe_assignments", "moe_chunks", "moe_held")
TOP_CHUNK = 16          # assignments of one expert a top-k work chunk holds
_STATS: dict[torch.device, torch.Tensor] = {}
_SMS: dict[torch.device, int] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    # x, scale, router, wi, wo, out, counts, stats, logits, hbuf, hid, prob,
    # meta, rows, d, d_ff, experts, seq_len, capacity, eps, sms, stream
    "gdr_moe_sublayer": [_P] * 13 + [_I] * 6 + [_F, _I, _P],
    # x, base, scale, router, bias, wi, wo, out, stats, logits, hbuf, hid,
    # ybuf, wgt, meta, route, rows, d, d_ff, experts, k, held, offset,
    # route_scale, eps, sms, stream
    "gdr_moe_topk_sublayer": [_P] * 16 + [_I] * 7 + [_F, _F, _I, _P],
}
MAX_D = 3584            # the router kernel's 8 staged rows in 112 KB, the
                        # top-k up product's 16 in 224 KB
MAX_K = 16              # experts a row of the top-k sublayer
MAX_DFF_TOPK = 3616     # the top-k down product's 16 staged rows in 227 KB
MAX_EXPERTS = 1024      # the grouping's one block keeps a count an expert


def stats_tensor(device: torch.device) -> torch.Tensor:
    """The routing counters [8] int64 of ``device``, made (zero) at the
    first use, which may not be under graph capture."""
    t = _STATS.get(device)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("expert_sublayer: the first call on a device "
                               "runs outside CUDA graph capture (it makes the "
                               "routing counters)")
        t = _STATS[device] = torch.zeros(len(STATS), dtype=torch.int64,
                                         device=device)
    return t


def read_stats() -> dict[str, int]:
    """The routing counters summed over devices (one sync each)."""
    total = [0] * len(STATS)
    for t in _STATS.values():
        total = [a + b for a, b in zip(total, t.tolist())]
    return dict(zip(STATS, total))


def reset_stats() -> None:
    for t in _STATS.values():
        t.zero_()


# ------------------------------------------------------------ plain version

def expert_sublayer_plain(x, ln_scale, router, wi, wo, *, capacity: int,
                          seq_len: int, counts=None, eps: float = 1e-6,
                          logits=None):
    r, _ = x.shape
    n_exp = router.shape[0]
    h = _rms(x, ln_scale, eps)
    z = _mm(h, router)                                    # f32 [R, E]
    if logits is not None:
        logits.copy_(z)
    probs = torch.softmax(z, dim=-1)
    e = torch.argmax(probs, dim=-1)
    pi = probs.gather(1, e[:, None])[:, 0]
    one = F.one_hot(e, n_exp).view(r // seq_len, seq_len, n_exp)
    prior = one.cumsum(1) - one                           # earlier tokens
    if counts is not None:
        prior = prior + counts[:, None].long()
        counts += one.sum(1).to(counts.dtype)
    keep = prior.view(r, n_exp).gather(1, e[:, None])[:, 0] < capacity
    y = torch.zeros_like(x)
    hit = torch.unique(e[keep]).tolist()
    for j in hit:
        rows = (keep & (e == j)).nonzero()[:, 0]
        hid = torch.relu(_mm(h[rows], wi[j])).to(x.dtype)
        y[rows] = _mm(hid, wo[j]).to(x.dtype)
    load = torch.bincount(e[keep], minlength=n_exp)
    stats_tensor(x.device).add_(torch.tensor(
        [1, r, len(hit), int(load.max()) if r else 0, int((~keep).sum()),
         r, 0, r],
        dtype=torch.int64, device=x.device))
    return x + pi[:, None].to(x.dtype) * y


# --------------------------------------------------------------- wrapper

def _lib():
    return build.load("experts", _SIGS)


def _sms(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def expert_sublayer(x, ln_scale, router, wi, wo, *, capacity: int,
                    seq_len: int, counts=None, eps: float = 1e-6,
                    logits=None):
    """x: [R, d]; ln_scale: [d]; router: [E, d]; wi: [E, d_ff, d]; wo: [E,
    d, d_ff]; ``counts``: [R / seq_len, E] int32 or None.  Returns x + π ·
    the routed expert's output (x for dropped tokens).  ``logits``: an f32
    [R, E] tensor the router's logits are written to."""
    r, d = x.shape
    n_exp, dff = wi.shape[0], wi.shape[1]
    if seq_len < 1 or r % seq_len:
        raise ValueError(f"expert_sublayer: {r} rows are not sequences of "
                         f"{seq_len}")
    for name, t, shape in (("router", router, (n_exp, d)),
                           ("wi", wi, (n_exp, dff, d)),
                           ("wo", wo, (n_exp, d, dff)),
                           ("counts", counts, (r // seq_len, n_exp)),
                           ("logits", logits, (r, n_exp))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"expert_sublayer {name}: expected shape {shape},"
                             f" got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return expert_sublayer_plain(x, ln_scale, router, wi, wo,
                                     capacity=capacity, seq_len=seq_len,
                                     counts=counts, eps=eps, logits=logits)
    if x.dtype != torch.float32:
        raise TypeError(f"expert_sublayer: the CUDA experts serve float32 "
                        f"models only, not {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"expert_sublayer: tensors on {x.device}, expected "
                         f"cpu or cuda")
    tensors = (x, ln_scale, router, wi, wo)
    for t in tensors + tuple(t for t in (counts, logits) if t is not None):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("expert_sublayer: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    if any(t.dtype != torch.float32 for t in tensors) or (
            counts is not None and counts.dtype != torch.int32):
        raise TypeError("expert_sublayer: f32 tensors and int32 counts")
    if d % 16 or d > MAX_D or dff % 32 or not 0 < n_exp <= MAX_EXPERTS:
        raise ValueError(f"expert_sublayer: d {d} (a multiple of 16, at most "
                         f"{MAX_D}), d_ff {dff} (a multiple of 32), {n_exp} "
                         f"experts (at most {MAX_EXPERTS}) not served")
    dev = x.device
    stats = stats_tensor(dev)
    out = torch.empty_like(x)
    if logits is None:
        logits = torch.empty((r, n_exp), dtype=torch.float32, device=dev)
    hbuf = torch.empty_like(x)
    hid = torch.empty((r, dff), dtype=torch.float32, device=dev)
    prob = torch.empty((r,), dtype=torch.float32, device=dev)
    meta = torch.empty((1 + 3 * (r // 8 + n_exp + 1) + 3 * r,),
                       dtype=torch.int32, device=dev)
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    build.check(lib, lib.gdr_moe_sublayer(
        x.data_ptr(), ln_scale.data_ptr(), router.data_ptr(), wi.data_ptr(),
        wo.data_ptr(), out.data_ptr(), ptr(counts), stats.data_ptr(),
        logits.data_ptr(), hbuf.data_ptr(), hid.data_ptr(), prob.data_ptr(),
        meta.data_ptr(), r, d, dff, n_exp, seq_len, capacity, eps, _sms(dev),
        torch.cuda.current_stream(dev).cuda_stream), "expert_sublayer")
    count("expert_sublayer")
    return out


# ------------------------------------------------- top-k (DeepSeek-V3)

def topk_select(z: torch.Tensor, bias: torch.Tensor, k: int, scale: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The experts [R, k] (ascending) and weights [R, k] f32 of router
    logits z [R, E]: the k largest sigmoid(z) + bias, the lower index first
    among equals; the weights their sigmoids over their sum, × scale."""
    s = torch.sigmoid(z.float())
    order = torch.sort(s + bias.float(), dim=1, descending=True,
                       stable=True).indices
    sel = order[:, :k].sort(dim=1).values
    w = s.gather(1, sel)
    return sel, w / (w.sum(1, keepdim=True) + 1e-20) * scale


def topk_expert_sublayer_plain(x, base, ln_scale, router, bias, wi, wo, *,
                               k: int, scale: float, eps: float = 1e-6,
                               route=None, logits=None, offset: int = 0):
    r, d = x.shape
    held, dff = wi.shape[0], wi.shape[1] // 2
    h = _rms(x, ln_scale, eps)
    z = _mm(h, router)                                    # f32 [R, E]
    sel, w = topk_select(z, bias, k, scale)
    if logits is not None:
        logits.copy_(z)
    if route is not None:
        route.copy_(sel.to(route.dtype))
    local = sel - offset
    mine = (local >= 0) & (local < held)
    y = torch.zeros((r, k, d), dtype=torch.float32, device=x.device)
    hit = torch.unique(local[mine]).tolist()
    for e in hit:
        rows, slot = (local == e).nonzero(as_tuple=True)
        gu = _mm(h[rows], wi[e])
        hid = F.silu(gu[:, :dff]) * gu[:, dff:]
        y[rows, slot] = _mm(hid, wo[e])
    out = base.float()
    for j in range(k):
        out = torch.where(mine[:, j:j + 1], out + w[:, j:j + 1] * y[:, j], out)
    load = torch.bincount(local[mine], minlength=held)
    stats_tensor(x.device).add_(torch.tensor(
        [1, r, len(hit), int(load.max()) if r else 0, 0, r * k,
         int(((load + TOP_CHUNK - 1) // TOP_CHUNK).sum()), int(mine.sum())],
        dtype=torch.int64, device=x.device))
    return out.to(x.dtype)


def topk_expert_sublayer(x, base, ln_scale, router, bias, wi, wo, *, k: int,
                         scale: float, eps: float = 1e-6, route=None,
                         logits=None, offset: int = 0):
    """x, base: [R, d]; ln_scale: [d]; router: [E, d]; bias: [E]; wi:
    [held, 2·d_ff, d] (gate rows, then up rows); wo: [held, d, d_ff], the
    experts ``offset`` … ``offset + held − 1`` of the E (all of them by
    default).  Returns base + the held routed experts' weighted sum (see
    the module's docstring).  ``route``: an int32 [R, k] tensor the chosen
    experts are written to; ``logits``: an f32 [R, E] tensor the router's
    logits are written to."""
    r, d = x.shape
    n_exp = router.shape[0]
    held, dff2 = wi.shape[0], wi.shape[1]
    dff = dff2 // 2
    for name, t, shape in (("base", base, (r, d)),
                           ("router", router, (n_exp, d)),
                           ("bias", bias, (n_exp,)),
                           ("wi", wi, (held, 2 * dff, d)),
                           ("wo", wo, (held, d, dff)),
                           ("route", route, (r, k)),
                           ("logits", logits, (r, n_exp))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"topk_expert_sublayer {name}: expected shape "
                             f"{shape}, got {tuple(t.shape)}")
    if not 0 < k <= min(n_exp, MAX_K):
        raise ValueError(f"topk_expert_sublayer: k {k} of {n_exp} experts "
                         f"(at most {MAX_K})")
    if not (held > 0 and offset >= 0 and offset + held <= n_exp):
        raise ValueError(f"topk_expert_sublayer: experts {offset} + {held} "
                         f"held of {n_exp}")
    if x.device.type == "cpu":
        return topk_expert_sublayer_plain(
            x, base, ln_scale, router, bias, wi, wo, k=k, scale=scale,
            eps=eps, route=route, logits=logits, offset=offset)
    if x.dtype != torch.float32:
        raise TypeError(f"topk_expert_sublayer: the CUDA experts serve "
                        f"float32 models only, not {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"topk_expert_sublayer: tensors on {x.device}, "
                         f"expected cpu or cuda")
    tensors = (x, base, ln_scale, router, bias, wi, wo)
    for t in tensors + tuple(t for t in (route, logits) if t is not None):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("topk_expert_sublayer: tensors must be "
                             "contiguous, 16-byte aligned and on one device")
    if any(t.dtype != torch.float32 for t in tensors) or (
            route is not None and route.dtype != torch.int32):
        raise TypeError("topk_expert_sublayer: f32 tensors and an int32 "
                        "route")
    if d % 16 or d > MAX_D or dff % 32 or dff > MAX_DFF_TOPK \
            or not 0 < n_exp <= MAX_EXPERTS:
        raise ValueError(f"topk_expert_sublayer: d {d} (a multiple of 16, at "
                         f"most {MAX_D}), d_ff {dff} (a multiple of 32, at "
                         f"most {MAX_DFF_TOPK}), {n_exp} experts (at most "
                         f"{MAX_EXPERTS}) not served")
    dev = x.device
    stats = stats_tensor(dev)
    a = r * k
    out = torch.empty_like(x)
    if logits is None:
        logits = torch.empty((r, n_exp), dtype=torch.float32, device=dev)
    hbuf = torch.empty_like(x)
    hid = torch.empty((a, dff), dtype=torch.float32, device=dev)
    ybuf = torch.empty((a, d), dtype=torch.float32, device=dev)
    wgt = torch.empty((a,), dtype=torch.float32, device=dev)
    meta = torch.empty((1 + 3 * (a // 16 + held + 1) + 2 * a,),
                       dtype=torch.int32, device=dev)
    lib = _lib()
    build.check(lib, lib.gdr_moe_topk_sublayer(
        x.data_ptr(), base.data_ptr(), ln_scale.data_ptr(), router.data_ptr(),
        bias.data_ptr(), wi.data_ptr(), wo.data_ptr(), out.data_ptr(),
        stats.data_ptr(), logits.data_ptr(), hbuf.data_ptr(), hid.data_ptr(),
        ybuf.data_ptr(), wgt.data_ptr(), meta.data_ptr(),
        None if route is None else route.data_ptr(), r, d, dff, n_exp, k,
        held, offset, scale, eps, _sms(dev),
        torch.cuda.current_stream(dev).cuda_stream),
        "topk_expert_sublayer")
    count("topk_expert_sublayer")
    return out
