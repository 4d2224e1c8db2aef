"""The weights of a GDR generator whose backbone is a decoder-only
DeepSeek-V3 stack (``reference/moonlight.py``), drawn from the seed on the
device straight into the port's parameters, which the plain reference then
reads under the same names: Moonlight-16B-A3B's 62.5 GB of f32 exist once.

Scales: ``weights.py``'s (embeddings and the PAWA memory N(0, 1), the
query projection N(0, 1/d), every other matrix N(0, 0.02), norm scales 1,
biases 0); the routers at N(0, 0.02²), ``transformers``' initialiser for
``DeepseekV3TopkRouter`` (logits of std 0.9 over RMS-normed rows of d =
2,048); the score-correction biases, which ``transformers`` starts at 0
and training moves, at N(0, :data:`BIAS_STD`²), an assumed scale, so that
the selection-only bias changes some choices.
"""

from __future__ import annotations

import torch

from gdrbench import weights

ROUTER_STD = 0.02
BIAS_STD = 0.01


def init_scale(name: str, d: int) -> float | None:
    """The standard deviation of a random leaf, or None for a constant."""
    if name.endswith(".ff.router"):
        return ROUTER_STD
    if name.endswith(".ff.score_bias"):
        return BIAS_STD
    return weights._init_scale(name, d)


@torch.no_grad()
def draw_into(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Fill ``model``'s parameters in place (in their order, from one
    generator on their device seeded by ``seed``) and return them by name,
    uncopied."""
    d = model.cfg.d_model
    params = dict(model.named_parameters())
    g = torch.Generator(device=next(iter(params.values())).device)
    g.manual_seed(seed)
    for name, p in params.items():
        std = init_scale(name, d)
        if std is None:
            p.fill_(0.0 if name.endswith("bias") else 1.0)
        else:
            p.normal_(0.0, std, generator=g)
    return params
