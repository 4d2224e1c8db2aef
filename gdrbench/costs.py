"""Operations and bytes of the work the cells drive, from shapes alone, and
the published peaks they are held to.

The decoder sublayers' cost (``decoder_cost``, ``core_bytes``), the bound
(``bound_s``) and the training step's cost (``train_step_cost``) are a
frozen copy of ``chip_smoke.py``'s arithmetic; ``retrieve_flops`` and
``decoder_calls`` add the model FLOPs of a whole retrieve: the encoder,
the cross-attention K/V, every decode step at its rows and position
(decoder, the candidate head, PAWA and its U contraction) and the
re-rank's dots.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside
them, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES = 3.35e12

DECODER = ("self_attn_sublayer", "cross_attn_sublayer", "ffn_sublayer")


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the chip could take: the larger of operations over
    ``peak`` and bytes over the HBM bandwidth."""
    return max(flops / peak, nbytes / H100_BYTES)


def decoder_cost(name: str, r: int, pos: int, lmax: int, el: int, *,
                 d: int = 768, heads: int = 12, dkv: int = 64,
                 dff: int = 3072, queries: int = 32, enc_len: int = 40
                 ) -> tuple[float, float]:
    """FLOPs and the bytes a decoder sublayer must move at r rows: each
    input read once (x, weights, the cache rows at positions < pos, the
    ``queries``' encoder K/V of ``enc_len`` tokens, biases, norm scale) and
    each output written once (x', the new K/V row); ``el`` bytes an
    element."""
    inner = heads * dkv
    if name == "self_attn_sublayer":
        flops = 2 * r * d * 3 * inner + 2 * r * inner * d \
            + 2 * 2 * r * heads * (pos + 1) * dkv
        nbytes = (2 * r * d + 4 * inner * d) * el + 2 * pos * r * inner * el \
            + 2 * r * inner * el + lmax * heads * 4 + d * 4
    elif name == "cross_attn_sublayer":
        flops = 2 * 2 * r * d * inner + 2 * 2 * r * heads * enc_len * dkv
        nbytes = (2 * r * d + 2 * inner * d) * el \
            + 2 * queries * heads * enc_len * dkv * el \
            + queries * heads * enc_len * 4 + d * 4
    else:
        flops = 2 * 2 * r * d * dff
        nbytes = (2 * r * d + 2 * d * dff) * el + d * 4
    return flops, nbytes


def core_bytes(name: str, r: int, pos: int, el: int, *, heads: int = 12,
               dkv: int = 64, queries: int = 32, enc_len: int = 40) -> float:
    """The bytes an attention core alone must move at r rows."""
    inner = heads * dkv
    if name == "self_attn_sublayer":
        return (3 * r * inner + 2 * pos * r * inner + 3 * r * inner) * el \
            + 4 * heads * 4
    return (2 * r * inner + 2 * queries * heads * enc_len * dkv) * el \
        + queries * heads * enc_len * 4


def beam_steps(batch: int, beams: int, kary: int, max_len: int
               ) -> list[tuple[int, int]]:
    """(rows, position) of every decode step of a beam search that runs
    all ``max_len`` steps with progressive widening 1, kary+1, … up to
    ``beams`` beams a query."""
    steps, w = [], 1
    for pos in range(max_len):
        steps.append((batch * w, pos))
        w = min(w * (kary + 1), beams)
    return steps


def decoder_calls(m: dict, batch: int, beams: int, max_len: int,
                  enc_len: int) -> list[tuple[str, int, int, int]]:
    """Every decoder-sublayer call of one retrieve: (kernel, rows,
    position, cache length)."""
    return [(name, r, pos, max_len)
            for r, pos in beam_steps(batch, beams, m["kary"], max_len)
            for _ in range(m["num_decoder_layers"]) for name in DECODER]


def decoder_bound_s(m: dict, batch: int, beams: int, max_len: int,
                    enc_len: int, el: int, peak: float) -> float:
    """The sum over one retrieve's decoder-sublayer calls of each call's
    bound."""
    kw = dict(d=m["d_model"], heads=m["num_heads"], dkv=m["d_kv"],
              dff=m["d_ff"], queries=batch, enc_len=enc_len)
    return sum(bound_s(*decoder_cost(n, r, pos, lmax, el, **kw), peak)
               for n, r, pos, lmax in decoder_calls(m, batch, beams, max_len,
                                                    enc_len))


def retrieve_flops(m: dict, batch: int, beams: int, max_len: int,
                   enc_len: int, docs_per_beam: float) -> float:
    """Model FLOPs of one retrieve: encoder, cross K/V, every step's
    decoder layers, candidate head, PAWA layers and U contraction, and the
    re-rank's dots over ``docs_per_beam`` documents a beam."""
    d, dff, h, dkv = m["d_model"], m["d_ff"], m["num_heads"], m["d_kv"]
    inner = h * dkv
    kary = m["kary"]
    te = batch * enc_len
    enc = m["num_layers"] * (2 * te * d * 3 * inner + 2 * te * inner * d
                             + 2 * 2 * batch * h * enc_len * enc_len * dkv
                             + 2 * 2 * te * d * dff)
    cross_kv = m["num_decoder_layers"] * 2 * te * d * 2 * inner
    pff = m["adaptor_d_ff"] or min(4 * d, 2048)
    steps = 0.0
    for r, pos in beam_steps(batch, beams, kary, max_len):
        kw = dict(d=d, heads=h, dkv=dkv, dff=dff, queries=batch,
                  enc_len=enc_len)
        steps += m["num_decoder_layers"] * sum(
            decoder_cost(n, r, pos, max_len, 4, **kw)[0] for n in DECODER)
        steps += 2 * r * d * (kary + 1)                       # tied head
        steps += m["adaptor_layer_num"] * (
            2 * r * d * 3 * d + 2 * r * d * d + 2 * 2 * r * (pos + 1) * d
            + 2 * 2 * r * d * pff)
        steps += 2 * r * d * (kary + 1) * d + 2 * r * (kary + 1) * d   # U
    rerank = 2 * batch * beams * docs_per_beam * d
    return enc + cross_kv + steps + rerank


def train_step_cost(m: dict, rows: int, seq: int, n_params: int
                    ) -> tuple[float, float]:
    """(FLOPs, bytes) of one stage-1 step at full width: 3 × the forward's
    matmul FLOPs (encoder over rows × seq tokens, decoder and PAWA layers
    over rows × L, U's candidate blocks) and AdamW's bytes (f32 parameter,
    gradient and two moments read, parameter and moments written)."""
    d, dff, L = m["d_model"], m["d_ff"], m["max_output_length"]
    inner = m["num_heads"] * m["d_kv"]
    te, td = rows * seq, rows * L
    attn = lambda q, k: 2 * 2 * rows * m["num_heads"] * q * k * m["d_kv"]
    enc = m["num_layers"] * (2 * te * d * 3 * inner + 2 * te * inner * d
                             + attn(seq, seq) + 4 * te * d * dff)
    dec = m["num_decoder_layers"] * (
        2 * td * d * 3 * inner + 2 * td * inner * d + attn(L, L)
        + 2 * td * d * inner + 2 * te * d * 2 * inner + 2 * td * inner * d
        + attn(L, seq) + 4 * td * d * dff)
    pawa_ff = m["adaptor_d_ff"] or min(4 * d, 2048)
    pawa = m["adaptor_layer_num"] * (2 * td * d * 3 * d + 2 * td * d * d
                                     + attn(L, L) + 2 * 2 * td * d * d
                                     + 4 * td * d * pawa_ff)
    u = 2 * td * d * (m["kary"] + 1) * d + 2 * td * (m["kary"] + 1) * d
    return 3.0 * (enc + dec + pawa + u), 28.0 * n_params
