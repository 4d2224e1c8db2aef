"""Operations and bytes of GDR's Kimi Linear generator (card 0's share of
Kimi-Linear-48B-A3B, f32), from shapes and from the routing counters the
program keeps on the device.

- :func:`retrieve_flops`: the model FLOPs of one retrieve that this card
  computes (``costs_moonlight.py``'s CID head, PAWA and dense stage, and
  the stack: KDA layers, NoPE MLA layers, the dense FFN, the router over
  all experts, the shared expert and, of the k routed experts a token,
  the k · held / E that fall to this card in expectation), for
  ``mfu.serve``;
- :func:`kda_decode_cost` / :func:`kda_prefill_cost` / :func:`kda_bound_s`:
  a KDA decode call reads each distinct source row's state (2 MB at 32
  heads of 128; at step 0 the query's prefix state) and convolution window
  once and writes every row's new ones, and reads the rows' projections
  and writes their outputs; the layer's small weights once.  The prefill
  reads the real tokens' projections and writes their outputs and each
  query's state and window.  The bound takes the counts from the
  program's counters (``kda_source_rows``, ``kda_prefill_tokens`` on the
  device, ``kda_state_rows`` on the host), at 3.35 TB/s or 67 TFLOP/s;
- :func:`decoder_bound_s`: the stack's products (``kernels/decode.py::gemm``:
  the KDA, MLA, dense and shared-expert projections) at every pass's rows,
  for ``decoder_roofline.serve``;
- the held experts' bound and the MLA bound are ``costs_moonlight.py``'s:
  :func:`topk_expert_bound_s` takes the assignments to held experts
  (``moe_held``) as the experts' work, :func:`mla_bound_s` the MLA layers.
"""

from __future__ import annotations

from gdrbench import costs_moonlight
from gdrbench.costs import H100_BYTES, H100_F32_FLOPS, beam_steps


def n_kda(m: dict) -> int:
    return len(m["kda_layers"])


def _kda_dims(m: dict):
    return m["kda_num_heads"], m["kda_head_dim"], m["kda_conv_size"]


def kda_token_flops(m: dict) -> float:
    """FLOPs of one token through a KDA layer: the products, the
    convolution, the low-rank up projections and the recurrence (decay,
    kᵀS, the rank-1 correction, Sᵀq: ~7 FLOPs a state element)."""
    d = m["d_model"]
    h, k, t = _kda_dims(m)
    inner = h * k
    proj = 2 * d * (3 * inner + 2 * k + h) + 2 * 2 * k * inner \
        + 2 * inner * d
    return proj + 2 * 3 * inner * t + 7 * h * k * k


def token_flops(m: dict, keys: float) -> float:
    """FLOPs of one token through the stack, the MLA layers attending to
    ``keys`` positions."""
    d = m["d_model"]
    n_mla = m["num_layers"] - n_kda(m)
    mla = costs_moonlight.token_flops({**m, "num_layers": n_mla,
                                       "first_k_dense": 0,
                                       "num_experts_per_tok": 0,
                                       "num_shared_experts": 0,
                                       "num_experts": 0}, keys)
    dense = 6 * d * m["d_ff"]
    held = m.get("experts_held") or m["num_experts"]
    moe = 2 * d * m["num_experts"] + (
        m["num_experts_per_tok"] * held / m["num_experts"]
        + m["num_shared_experts"]) * 6 * d * m["moe_d_ff"]
    k = m["first_k_dense"]
    return n_kda(m) * kda_token_flops(m) + mla + k * dense \
        + (m["num_layers"] - k) * moe


def retrieve_flops(m: dict, batch: int, beams: int, max_len: int,
                   enc_len: int, docs_per_beam: float) -> float:
    heads = costs_moonlight.retrieve_flops(
        {**m, "num_layers": 0, "first_k_dense": 0}, batch, beams, max_len,
        enc_len, docs_per_beam)
    prefill = batch * sum(token_flops(m, j + 1) for j in range(enc_len))
    steps = sum(r * token_flops(m, enc_len + pos + 1)
                for r, pos in beam_steps(batch, beams, m["kary"], max_len))
    return heads + prefill + steps


def _kda_weights(m: dict) -> int:
    """Floats of a layer's weights that the KDA kernels read: the up
    projections, the taps, A_log, dt_bias, the norm's scale."""
    h, k, t = _kda_dims(m)
    return 2 * h * k * k + 3 * h * k * t + h + h * k + k


def _kda_row(m: dict) -> tuple[int, int, int]:
    """Floats of (a row's state and window, a token row's projections in
    and output out) and FLOPs of one token."""
    h, k, t = _kda_dims(m)
    return (h * k * k + (t - 1) * 3 * h * k,
            3 * h * k + 2 * k + h + h * k,
            7 * h * k * k + 2 * 2 * k * h * k + 2 * 3 * h * k * t)


def kda_decode_cost(m: dict, rows: int, sources: int, calls: int = 1
                    ) -> tuple[float, float]:
    """(FLOPs, bytes) of ``calls`` KDA decode calls that wrote ``rows``
    rows' states and read ``sources`` distinct source rows' (each source's
    state and window read once, however many rows continue it; at step 0
    the query's prefix state), the rows' projections in and outputs out,
    and the layer's small weights once a call."""
    state, tok, flops = _kda_row(m)
    nbytes = 4 * ((sources + rows) * state + rows * tok
                  + calls * _kda_weights(m))
    return float(rows * flops), float(nbytes)


def kda_prefill_cost(m: dict, queries: int, tokens: int, calls: int = 1
                     ) -> tuple[float, float]:
    """(FLOPs, bytes) of ``calls`` KDA prefills over ``queries`` queries
    of ``tokens`` real tokens in all (the kernel runs no pad): the tokens'
    projections in and outputs out, each query's state and window out, the
    layer's small weights once a call."""
    state, tok, flops = _kda_row(m)
    nbytes = 4 * (tokens * tok + queries * state + calls * _kda_weights(m))
    return float(tokens * flops), float(nbytes)


def _bound(cost) -> float:
    flops, nbytes = cost
    return max(flops / H100_F32_FLOPS, nbytes / H100_BYTES)


def kda_bound_s(m: dict, counts: dict, batch: int) -> float:
    """The least time of the KDA calls that ``counts`` counts: the
    launches ``kda_prefill`` / ``kda_decode``, the host counter
    ``kda_state_rows`` and the device counters ``kda_source_rows``,
    ``kda_prefill_tokens``, over a stretch of retrieves of ``batch``
    queries.  Each kind's FLOPs and bytes are summed before their bound is
    taken, which is the sum of the calls' bounds where every call is
    bound by the same one (the decode calls, by bytes, at any rows)."""
    pre, dec = counts["kda_prefill"], counts["kda_decode"]
    return _bound(kda_prefill_cost(m, pre * batch,
                                   counts["kda_prefill_tokens"], pre)) \
        + _bound(kda_decode_cost(m, counts["kda_state_rows"],
                                 counts["kda_source_rows"], dec))


def _gemm_bound(rows: int, n: int, k: int, epi: str) -> float:
    """One ``kernels/decode.py::gemm`` call, f32: 2·rows·n·k FLOPs; its
    input, weight and output once, and the residual read ("residual") or
    the norm's scale ("round", whose RMSNorm is part of the product)."""
    extra = rows * n if epi == "residual" else k
    return _bound((2.0 * rows * n * k,
                   4.0 * (rows * k + n * k + rows * n + extra)))


def stack_gemms(m: dict) -> list[tuple[int, int, str]]:
    """(n, k, epilogue) of every ``gemm`` call of one pass of the stack:
    a KDA layer's qkv, fgb and o; an MLA layer's q, kv_a, kv_b and o; the
    dense layers' and the shared experts' SwiGLU (in, out)."""
    d = m["d_model"]
    h, k, _ = _kda_dims(m)
    heads, rank = m["num_heads"], m["kv_lora_rank"]
    nope, rp, v = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    kda = [(3 * h * k, d, "round"), (2 * k + h, d, "round"),
           (d, h * k, "residual")]
    mla = [(heads * (nope + rp), d, "round"), (rank + rp, d, "round"),
           (heads * (nope + v), rank, "round"), (d, heads * v, "residual")]
    dense = [(2 * m["d_ff"], d, "round"), (d, m["d_ff"], "residual")]
    ds = m["moe_d_ff"] * m["num_shared_experts"]
    shared = [(2 * ds, d, "round"), (d, ds, "residual")]
    kl, kd = n_kda(m), m["first_k_dense"]
    return (kda * kl + mla * (m["num_layers"] - kl) + dense * kd
            + shared * (m["num_layers"] - kd))


def decoder_bound_s(m: dict, batch: int, beams: int, max_len: int,
                    enc_len: int) -> float:
    """The sum of the bounds of one retrieve's stack products (the port's
    ``gdr::gemm_*`` and ``gdr::rms_norm`` kernels, which
    ``decoder_roofline.serve`` times): every ``stack_gemms`` call at the
    prefill's ``batch · enc_len`` rows and at every step's rows."""
    passes = [batch * enc_len] + [
        r for r, _ in beam_steps(batch, beams, m["kary"], max_len)]
    gemms = stack_gemms(m)
    return sum(_gemm_bound(r, n, k, epi) for r in passes
               for n, k, epi in gemms)


def mla_bound_s(m: dict, batch: int, beams: int, max_len: int,
                enc_len: int) -> float:
    return costs_moonlight.mla_bound_s(
        {**m, "num_layers": m["num_layers"] - n_kda(m)}, batch, beams,
        max_len, enc_len)


def topk_expert_bound_s(m: dict, stats: dict) -> float:
    return costs_moonlight.topk_expert_bound_s(
        m, {**stats, "moe_assignments": stats["moe_held"]})
