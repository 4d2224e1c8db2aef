"""Operations and bytes of GDR's decoder-only DeepSeek-V3 generator
(Moonlight-16B-A3B, f32), from shapes and from the routing counters the
program keeps on the device.

- :func:`retrieve_flops`: the model FLOPs of one retrieve (the prefill over
  every padded query position, each CID step at its rows and keys, GDR's
  CID head, PAWA and its U contraction, the dense stage's projection and
  re-rank dots), for ``mfu.serve``;
- :func:`topk_expert_cost` / :func:`topk_expert_bound_s`: the top-k expert
  calls the counters count must read each expert they send a row to (wi
  and wo, 3·d·d_ff f32) and the router once, and each row once in and
  once out; they do 2·rows·d·E FLOPs in the router and 6·d·d_ff for each
  assignment, under the H100's f32 ridge while an expert has fewer than
  ~40 rows, so the bytes bound them;
- :func:`mla_cost` / :func:`mla_bound_s`: one MLA decode step reads each
  query's prefix keys and values of every head once, the rows' raw q,
  k_pe and kv_b projections, and the row's cached steps; it writes the
  step's key and value and the output.
"""

from __future__ import annotations

from gdrbench.costs import H100_BYTES, H100_F32_FLOPS, beam_steps


def _dims(m: dict):
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return m["d_model"], m["num_heads"], qk, m["v_head_dim"]


def token_flops(m: dict, keys: float) -> float:
    """FLOPs of one token through the stack, attending to ``keys``
    positions."""
    d, h, qk, v = _dims(m)
    rank, rp = m["kv_lora_rank"], m["qk_rope_head_dim"]
    proj = 2 * d * (h * qk + rank + rp) + 2 * rank * h * (
        m["qk_nope_head_dim"] + v) + 2 * h * v * d
    core = 2 * h * keys * (qk + v)
    dense = 6 * d * m["d_ff"]
    moe = 2 * d * m["num_experts"] + (m["num_experts_per_tok"]
                                      + m["num_shared_experts"]) \
        * 6 * d * m["moe_d_ff"]
    k = m["first_k_dense"]
    return m["num_layers"] * (proj + core) + k * dense \
        + (m["num_layers"] - k) * moe


def retrieve_flops(m: dict, batch: int, beams: int, max_len: int,
                   enc_len: int, docs_per_beam: float) -> float:
    d, kary = m["d_model"], m["kary"]
    pff = m["adaptor_d_ff"] or min(4 * d, 2048)
    prefill = batch * sum(token_flops(m, j + 1) for j in range(enc_len))
    steps = 0.0
    for r, pos in beam_steps(batch, beams, kary, max_len):
        steps += r * token_flops(m, enc_len + pos + 1)
        steps += 2 * r * d * (kary + 1)                       # CID head
        steps += m["adaptor_layer_num"] * (
            2 * r * d * 3 * d + 2 * r * d * d + 2 * 2 * r * (pos + 1) * d
            + 2 * 2 * r * d * pff)
        steps += 2 * r * d * (kary + 1) * d + 2 * r * (kary + 1) * d   # U
    dense = 2 * batch * d * m["encoder_d_model"] \
        + 2 * batch * beams * docs_per_beam * m["encoder_d_model"]
    return prefill + steps + dense


def topk_expert_cost(m: dict, stats: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of the top-k expert calls ``stats`` counts
    (``moe_calls``, ``moe_rows``, ``moe_experts_hit``,
    ``moe_assignments``)."""
    d, f, n = m["d_model"], m["moe_d_ff"], m["num_experts"]
    rows = stats["moe_rows"]
    flops = 2 * rows * d * n + 6 * stats["moe_assignments"] * d * f
    nbytes = (stats["moe_experts_hit"] * 3 * d * f
              + stats["moe_calls"] * (n * d + n) + rows * 2 * d) * 4
    return float(flops), float(nbytes)


def topk_expert_bound_s(m: dict, stats: dict) -> float:
    flops, nbytes = topk_expert_cost(m, stats)
    return max(flops / H100_F32_FLOPS, nbytes / H100_BYTES)


def mla_cost(m: dict, batch: int, rows: int, pos: int, enc_len: int
             ) -> tuple[float, float]:
    """(FLOPs, bytes) of one MLA decode call at ``rows`` rows of ``batch``
    queries, position ``pos``, ``enc_len`` prefix positions."""
    d, h, qk, v = _dims(m)
    rank, rp = m["kv_lora_rank"], m["qk_rope_head_dim"]
    keys = enc_len + pos + 1
    flops = 2 * rows * h * keys * (qk + v)
    prefix = batch * h * enc_len * (qk + v) + batch * (enc_len + 1)
    per_row = h * qk + rp + h * (m["qk_nope_head_dim"] + v)   # q, k_pe, kv_b
    cached = (pos + 1) * h * (qk + v)                          # own steps
    written = h * (qk + v) + h * v
    nbytes = 4 * (prefix + rows * (per_row + cached + written)
                  + m["qk_rope_head_dim"] // 2)
    return float(flops), float(nbytes)


def mla_bound_s(m: dict, batch: int, beams: int, max_len: int,
                enc_len: int) -> float:
    """The least time of one retrieve's MLA calls: every layer at every
    step of a search that runs all ``max_len`` steps."""
    return m["num_layers"] * sum(
        max(f / H100_F32_FLOPS, b / H100_BYTES)
        for f, b in (mla_cost(m, batch, r, pos, enc_len)
                     for r, pos in beam_steps(batch, beams, m["kary"],
                                              max_len)))
