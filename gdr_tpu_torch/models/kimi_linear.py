"""Kimi Linear's hybrid stack (Kimi-Linear-48B-A3B: Moonshot AI 2025,
arXiv:2510.26692) as GDR's generator: DeepSeek-V3's layers
(``models/deepseek.py``: pre-norm, NoPE latent attention, a dense first
FFN, then routed SwiGLU experts with shared ones) with three of every
four attentions replaced by Kimi Delta Attention (KDA), a gated delta
rule with a recurrent state, in the model dtype (f32 on the card).

A KDA layer, on h = RMSNorm(x) (the ``fla`` library's
``KimiDeltaAttention``, which the report's layer equations follow):

    q, k, v = SiLU(causal depthwise conv_4(W_{q,k,v} h))   (H × K each)
    q = l2norm(q) · K^-½;   k = l2norm(k)                   (per head)
    g = −exp(A_log[head]) · softplus(W_fb W_fa h + dt_bias) (per channel)
    β = sigmoid(W_b h)                                      (per head)
    S ← diag(exp g) S;   S ← S + β k (vᵀ − kᵀS);   o = Sᵀq  (S [K, V] a head)
    o ← RMSNorm_head(o) ⊙ sigmoid(W_gb W_ga h);   x += W_o o

W_{q,k,v} is one [3·H·K, d] product (``qkv``) and W_fa, W_ga, W_b one [2K
+ H, d] product (``fgb``), each with the block's RMSNorm fused in front
(``kernels/decode.py::gemm``); the up projections W_fb, W_gb, the
convolution, the gates, the recurrence and the gated norm run in the KDA
kernels (``kernels/kda.py``).  The biases of the low-rank projections, the
norms' eps, and A_log's and dt_bias's initialisation are assumed (the
benchmark configuration's ``assumed`` lists them).

GDR's glue, as in ``deepseek.py``: the query's real tokens run causally
(pads are never attended to and never enter a recurrence); each KDA
layer's state and convolution window after the query's last real token
are kept per query (``cross_kda_s_<i>`` [B, H, K, V], ``cross_kda_c_<i>``
[B, 3, 3·H·K]).  CID step t continues from them: at step 0 every beam row
reads its query's prefix state, so no per-beam copy is made; from then on
each row reads its source beam's state from the buffer the last step
wrote and writes its own into the other one (``rec_kda_s<p>_<i>``,
``rec_kda_c<p>_<i>``, p = t mod 2), taking the step's source rows from
``rec_src``, which the beam search sets (``ops/beam.py::_reorder_cache``
leaves ``rec_`` entries to the model).  A buffer is made when a step's
rows first differ from what it holds (the widening steps), so a replayed
decode finds the states at fixed addresses.
"""

from __future__ import annotations

import torch
from torch import nn

from gdr_tpu_torch.kernels.decode import gemm
from gdr_tpu_torch.kernels.kda import kda_decode, kda_prefill
from gdr_tpu_torch.models.deepseek import DeepseekStack
from gdr_tpu_torch.models.t5 import RMSNorm
from gdr_tpu_torch.utils.timing import span


def _buffer(cache: dict, name: str, like: torch.Tensor, rows: int
            ) -> torch.Tensor:
    """``cache[name]``, made anew with ``rows`` rows of ``like``'s shape
    when it holds another number."""
    t = cache.get(name)
    if t is None or t.shape[0] != rows:
        t = cache[name] = like.new_empty((rows,) + tuple(like.shape[1:]))
    return t


class KDAttention(nn.Module):
    """A KDA layer's weights in ``nn.Linear`` layout [out, in]: ``qkv``
    [3HK, d], ``conv`` [3HK, T], ``fgb`` [2K + H, d] (W_fa, W_ga, W_b),
    ``f_b`` [HK, K], ``g_b`` [HK, K], ``A_log`` [H], ``dt_bias`` [HK],
    ``o_norm`` (scale [K]) and ``o`` [d, HK]."""

    def __init__(self, d: int, heads: int, dk: int, taps: int, eps: float):
        super().__init__()
        self.heads = heads
        inner = heads * dk
        self.qkv = nn.Linear(d, 3 * inner, bias=False)
        self.conv = nn.Parameter(torch.zeros(3 * inner, taps))
        self.fgb = nn.Linear(d, 2 * dk + heads, bias=False)
        self.f_b = nn.Linear(dk, inner, bias=False)
        self.g_b = nn.Linear(dk, inner, bias=False)
        self.A_log = nn.Parameter(torch.zeros(heads))
        self.dt_bias = nn.Parameter(torch.zeros(inner))
        self.o_norm = RMSNorm(dk, eps)
        self.o = nn.Linear(inner, d, bias=False)

    def _project(self, x, ln: RMSNorm):
        return (gemm(x, self.qkv.weight, "round", scale=ln.scale, eps=ln.eps),
                gemm(x, self.fgb.weight, "round", scale=ln.scale, eps=ln.eps))

    def _weights(self) -> tuple:
        return (self.f_b.weight, self.g_b.weight, self.conv, self.A_log,
                self.dt_bias, self.o_norm.scale)

    def prefill(self, i: int, ln: RMSNorm, xs, geo: dict, inv_freq,
                cache: dict):
        """xs [B·S, d] + this layer over the query's real tokens; the state
        and window after the last one to ``cache``."""
        qkv, fgb = self._project(xs, ln)
        with span("gdr.kda", f"rows={xs.shape[0]} prefill"):
            o, state, conv = kda_prefill(
                qkv, fgb, *self._weights(), geo["lens"], batch=geo["batch"],
                heads=self.heads, eps=self.o_norm.eps)
        cache[f"cross_kda_s_{i}"] = state
        cache[f"cross_kda_c_{i}"] = conv
        return gemm(o, self.o.weight, "residual", resid=xs)

    def init_cache(self, i: int, cache: dict, max_len: int, rows: int):
        """Nothing: the steps make their state buffers."""

    def decode(self, i: int, ln: RMSNorm, x, cache: dict, pos: int,
               num_beams: int, inv_freq):
        """x [B·W, d] + this layer of the step at ``pos``: each row's state
        read at its source, the new one written to this step's buffer."""
        r = x.shape[0]
        qkv, fgb = self._project(x, ln)
        if pos == 0:
            s_in, c_in, src = (cache[f"cross_kda_s_{i}"],
                               cache[f"cross_kda_c_{i}"], None)
        else:
            p = (pos - 1) % 2
            s_in, c_in = cache[f"rec_kda_s{p}_{i}"], cache[f"rec_kda_c{p}_{i}"]
            src = cache.get("rec_src")
        s_out = _buffer(cache, f"rec_kda_s{pos % 2}_{i}", s_in, r)
        c_out = _buffer(cache, f"rec_kda_c{pos % 2}_{i}", c_in, r)
        with span("gdr.kda", f"rows={r} pos={pos}"):
            o = kda_decode(qkv, fgb, *self._weights(), s_in, c_in, src,
                           s_out, c_out, heads=self.heads,
                           eps=self.o_norm.eps)
        return gemm(o, self.o.weight, "residual", resid=x)


class KimiLinearStack(DeepseekStack):
    """:class:`DeepseekStack` with a KDA layer at each of
    ``ModelConfig.kda_layers``."""

    @staticmethod
    def attention(c, i: int) -> nn.Module | None:
        if not c.is_kda(i):
            return None
        return KDAttention(c.d_model, c.kda_num_heads, c.kda_head_dim,
                           c.kda_conv_size, c.layer_norm_epsilon)
