"""The weights of a GDR generator whose backbone is Kimi Linear's hybrid
stack (``reference/kimi_linear.py``), drawn from the seed on the device
straight into the port's parameters, which the plain reference then reads
under the same names: card 0's share of Kimi-Linear-48B-A3B, ~40 GB of
f32, exists once.

Scales: ``weights_moonlight.py``'s (embeddings and the PAWA memory N(0,
1), the query projection N(0, 1/d), the routers N(0, 0.02²), the
score-correction biases N(0, 0.01²), every other matrix N(0, 0.02²), norm
scales 1) and, for a KDA layer's own leaves, the ``fla`` library's
initialisers of ``KimiDeltaAttention`` (assumed for the checkpoint, which
is trained): the convolution taps U(−½, ½) (``nn.Conv1d``'s, fan-in 4);
A_log = log U(1, 16); dt_bias = softplus⁻¹(dt), dt log-uniform in [10⁻³,
10⁻¹] and at least 10⁻⁴.
"""

from __future__ import annotations

import math

import torch

from gdrbench import weights_moonlight

DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4


@torch.no_grad()
def _kda_leaf(name: str, p: torch.Tensor, g: torch.Generator) -> bool:
    """Draw a KDA layer's own leaf ``p`` in place; False for any other."""
    if name.endswith(".attn.conv"):
        p.uniform_(-0.5, 0.5, generator=g)
    elif name.endswith(".attn.A_log"):
        p.uniform_(1.0, 16.0, generator=g).log_()
    elif name.endswith(".attn.dt_bias"):
        p.uniform_(math.log(DT_MIN), math.log(DT_MAX), generator=g).exp_()
        p.clamp_(min=DT_FLOOR)
        p.add_(torch.log(-torch.expm1(-p)))          # softplus⁻¹
    else:
        return False
    return True


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
        if _kda_leaf(name, p, g):
            continue
        std = weights_moonlight.init_scale(name, d)
        if std is None:
            p.fill_(0.0 if name.endswith("bias") else 1.0)
        else:
            p.normal_(0.0, std, generator=g)
    return params
