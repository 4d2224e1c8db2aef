"""Operations and bytes of the routed-expert sublayers (Switch Transformer,
f32), from the routing counters that the program keeps on the device
(``kernels.launch_counts(experts=True)``) over a stretch of calls.

A call of ``rows`` tokens over ``E`` experts of width d × d_ff must read
the router [E, d] and each expert it sends a token to (wi and wo, 2·d·d_ff
f32) once, and each row once in and once out; it does 2·rows·d·E FLOPs in
the router and 4·d·d_ff for each kept row.  Every call a serving step
makes is memory-bound in f32 (at most 2·rows/4 FLOP a byte, under the
H100's ridge of 67 TFLOP/s / 3.35 TB/s = 20 while an expert has fewer than
40 rows), so the summed bytes over the bandwidth bound the stretch.
"""

from __future__ import annotations

from gdrbench.costs import (DECODER, H100_BYTES, H100_F32_FLOPS, beam_steps,
                            bound_s, decoder_cost)
from gdrbench.reference.switch import sparse


def expert_cost(m: dict, stats: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of the expert calls ``stats`` counts (``moe_calls``,
    ``moe_rows``, ``moe_experts_hit``, ``moe_dropped``)."""
    d, dff, n = m["d_model"], m["d_ff"], m["num_experts"]
    rows, kept = stats["moe_rows"], stats["moe_rows"] - stats["moe_dropped"]
    flops = 2 * rows * d * n + 4 * kept * d * dff
    nbytes = (stats["moe_experts_hit"] * 2 * d * dff
              + stats["moe_calls"] * (n * d + d) + rows * 2 * d) * 4
    return float(flops), float(nbytes)


def expert_bound_s(m: dict, stats: dict) -> float:
    """The least time the card could take for those calls."""
    flops, nbytes = expert_cost(m, stats)
    return max(flops / H100_F32_FLOPS, nbytes / H100_BYTES)


def router_flops(m: dict, batch: int, beams: int, max_len: int,
                 enc_len: int) -> float:
    """The routers' FLOPs of one retrieve (its experts cost what the dense
    FFN they replace costs): every encoder token at each sparse encoder
    layer, every beam row of every decode step at each sparse decoder
    layer."""
    def layers(n, step):
        return sum(sparse(i, step) for i in range(n))
    per_row = 2 * m["d_model"] * m["num_experts"]
    dec_rows = sum(r for r, _ in beam_steps(batch, beams, m["kary"], max_len))
    return per_row * (layers(m["num_layers"], m["encoder_sparse_step"])
                      * batch * enc_len
                      + layers(m["num_decoder_layers"],
                               m["decoder_sparse_step"]) * dec_rows)


def decoder_bound_s(m: dict, batch: int, beams: int, max_len: int,
                    enc_len: int, el: int, peak: float) -> float:
    """``costs.decoder_bound_s`` over the decoder-sublayer calls that the
    dense kernels make in one retrieve: every layer's two attention
    sublayers, and ``ffn_sublayer`` at the dense layers alone (a sparse
    layer's FFN is the experts')."""
    kw = dict(d=m["d_model"], heads=m["num_heads"], dkv=m["d_kv"],
              dff=m["d_ff"], queries=batch, enc_len=enc_len)
    names = [DECODER[:2] if sparse(i, m["decoder_sparse_step"]) else DECODER
             for i in range(m["num_decoder_layers"])]
    return sum(bound_s(*decoder_cost(n, r, pos, max_len, el, **kw), peak)
               for r, pos in beam_steps(batch, beams, m["kary"], max_len)
               for layer in names for n in layer)
