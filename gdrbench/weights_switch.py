"""The weights of a GDR generator whose backbone is a Switch Transformer,
made from the seed on the device and handed alike to the program and to
the plain reference (``reference/switch.py``).

``param_shapes`` is ``weights.param_shapes`` with the FFN of every sparse
layer (``transformers``' placement: layer i of a stack with step s when
``i % s == 1``, or every layer at s = 1) replaced by the router
``ff.router`` [E, d] and the stacked experts ``ff.wi`` [E, d_ff, d] and
``ff.wo`` [E, d, d_ff], the names the port gives them.  ``make_weights``
draws one flat normal tensor and hands out views of it, each leaf scaled
in place as ``weights.py`` scales it, but for the routers, at
N(0, :data:`ROUTER_STD`²); so the ~23 GB of Switch-Base's experts exist
once.  ``load_into`` makes those tensors the module's parameters without a
copy.

The routers' scale is assumed: no scale of a trained Switch router's
logits is published, and the checkpoint is not in the repository.  The
two initialisers bracket it: ``transformers`` draws the routers at
N(0, 1), which over RMS-normed rows of d = 768 gives logits of std 28;
the Switch paper (Fedus et al. 2021, §2.4) draws every weight at std
sqrt(0.1 / fan-in), logits of std 0.32.  At N(0, 1) a token whose top two
experts are close passes a rounding change of its logits on to its
residual scaled by π(1 − π)·|y|, so each sparse layer multiplies f32
rounding ~3-fold: the program's and the plain reference's logits, both
exact f32 in different summation orders, differ by up to 9.9e-4, and a
tie gap ten times that leaves out about half the queries.  At std 0.2
(logits of std 5.5, the top expert still taking most of the softmax) a
sparse layer damps rounding as a dense one does.
"""

from __future__ import annotations

import math

import torch

from gdrbench import weights
from gdrbench.reference.switch import sparse


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """Leaf name -> shape of the generator described by the ``model`` block
    ``m`` of a configuration file (with ``num_experts`` and the sparse
    steps)."""
    d, dff, n = m["d_model"], m["d_ff"], m["num_experts"]
    out = {}
    for name, shape in weights.param_shapes(m).items():
        stack, _, i, rest = (name.split(".", 3) + ["", "", ""])[:4]
        step = {"encoder": m["encoder_sparse_step"],
                "decoder": m["decoder_sparse_step"]}.get(stack)
        if step is None or rest not in ("ff.wi.weight", "ff.wo.weight") \
                or not sparse(int(i), step):
            out[name] = shape
        elif rest == "ff.wi.weight":
            p = f"{stack}.blocks.{i}.ff."
            out.update({p + "router": (n, d), p + "wi": (n, dff, d),
                        p + "wo": (n, d, dff)})
    return out


ROUTER_STD = 0.2


def init_scale(name: str, d: int) -> float | None:
    """The standard deviation of a random leaf, or None for a constant."""
    if name.endswith(".ff.router"):
        return ROUTER_STD
    return weights._init_scale(name, d)


@torch.no_grad()
def make_weights(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf in float32 on ``device``: ``weights.make_weights`` over
    this module's leaves and scales (views of one normal draw from a
    generator on ``device`` seeded by ``seed``, scaled in place; norm
    scales 1 and biases 0 are their own tensors)."""
    shapes = param_shapes(m)
    random = [(n, s, init_scale(n, m["d_model"])) for n, s in shapes.items()]
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


def load_into(module: torch.nn.Module, w: dict[str, torch.Tensor]) -> None:
    """Give ``module`` the float32 tensors ``w`` as its parameters,
    uncopied; fails unless the names and shapes are the module's."""
    module.load_state_dict(w, strict=True, assign=True)
