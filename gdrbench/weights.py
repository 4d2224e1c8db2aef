"""The generator's weights, made from the seed on the device in a few large
calls, and handed alike to the program and to the plain reference.

``param_shapes`` lists every leaf of the GDR generator (T5 encoder, CID
decoder, efficient PAWA head) from the configuration alone, under the
names the port's ``GenerativeRetriever`` gives its parameters; a CPU test
holds the list to the port's.  ``make_weights`` draws one flat normal
tensor for all random leaves and cuts it, each leaf scaled by the
initialiser scale of its kind (embeddings and the PAWA memory N(0, 1),
projections, relative-bias tables and U N(0, 0.02), a query projection
N(0, 1/d)), norm scales 1 and biases 0.
"""

from __future__ import annotations

import math

import torch


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """Leaf name -> shape of the generator described by the ``model``
    block ``m`` of a configuration file."""
    d, dff, h, dkv = m["d_model"], m["d_ff"], m["num_heads"], m["d_kv"]
    inner = h * dkv
    nb = m["relative_attention_num_buckets"]
    dec_vocab = m["kary"] * m["max_output_length"] + 2
    out: dict[str, tuple[int, ...]] = {"shared.weight": (m["vocab_size"], d)}
    out["encoder.rel_bias.rel_embedding"] = (nb, h)
    for i in range(m["num_layers"]):
        p = f"encoder.blocks.{i}."
        out.update({p + "ln1.scale": (d,), p + "attn.qkv.weight": (3 * inner, d),
                    p + "attn.o.weight": (d, inner), p + "ln2.scale": (d,),
                    p + "ff.wi.weight": (dff, d), p + "ff.wo.weight": (d, dff)})
    out["encoder.final_norm.scale"] = (d,)
    out["decode_embed.weight"] = (dec_vocab, d)
    out["decoder.rel_bias.rel_embedding"] = (nb, h)
    out["decoder.cross_rel_bias.rel_embedding"] = (nb, h)
    for i in range(m["num_decoder_layers"]):
        p = f"decoder.blocks.{i}."
        out.update({p + "ln1.scale": (d,),
                    p + "self_attn.qkv.weight": (3 * inner, d),
                    p + "self_attn.o.weight": (d, inner), p + "ln2.scale": (d,),
                    p + "cross_attn.qkv.weight": (3 * inner, d),
                    p + "cross_attn.o.weight": (d, inner), p + "ln3.scale": (d,),
                    p + "ff.wi.weight": (dff, d), p + "ff.wo.weight": (d, dff)})
    out["decoder.final_norm.scale"] = (d,)
    if m["encoder_d_model"] != d:
        out["query_proj.weight"] = (m["encoder_d_model"], d)
    pff = m["adaptor_d_ff"] or min(4 * d, 2048)
    out["pawa.memory"] = (1, 1, d)
    out["pawa.u"] = (d, dec_vocab, d)
    for i in range(m["adaptor_layer_num"]):
        p = f"pawa.layers.{i}."
        for a in ("self_attn", "cross_attn"):
            out[p + a + ".qkv.weight"] = (3 * d, d)
            out[p + a + ".o.weight"] = (d, d)
        for n in ("ln1", "ln2", "ln3"):
            out[p + n + ".weight"] = (d,)
            out[p + n + ".bias"] = (d,)
        out[p + "ff1.weight"] = (pff, d)
        out[p + "ff2.weight"] = (d, pff)
    return out


def _init_scale(name: str, d: int) -> float | None:
    """The standard deviation of a random leaf, or None for a constant."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "bias") or (leaf == "weight" and ".ln" in name):
        return None
    if name in ("shared.weight", "decode_embed.weight", "pawa.memory"):
        return 1.0
    if name == "query_proj.weight":
        return d ** -0.5
    return 0.02


@torch.no_grad()
def make_weights(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf in float32 on ``device``: one normal draw of all random
    leaves from a generator on ``device`` seeded by ``seed``, cut and
    scaled in place."""
    shapes = param_shapes(m)
    random = [(n, s, _init_scale(n, m["d_model"])) for n, s in shapes.items()]
    total = sum(math.prod(s) for _, s, std in random if std is not None)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, std in random:
        if std is None:
            out[name] = torch.full(shape, 0.0 if name.endswith("bias") else 1.0,
                                   device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out


def load_into(module: torch.nn.Module, weights: dict[str, torch.Tensor],
              dtype: torch.dtype) -> None:
    """Give ``module`` (built on the meta device) copies of ``weights`` in
    ``dtype`` as its parameters; fails unless the names and shapes are the
    module's."""
    module.load_state_dict({n: w.to(dtype=dtype, copy=True)
                            for n, w in weights.items()},
                           strict=True, assign=True)
