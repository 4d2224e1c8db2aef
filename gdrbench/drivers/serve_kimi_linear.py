"""Serving on Kimi Linear's hybrid generator (card 0's share of
Kimi-Linear-48B-A3B): ``serve_moonlight.py``'s closed loop of one caller
over ``Evaluator.retrieve``, its set-up, traced stretch, route recording
and comparison, run with what this configuration changes:

- the weights: the model is built on the card and its parameters drawn in
  place from the seed (``weights_kimi_linear.py``), ~40 GB once;
- the plain reference is ``reference/kimi_linear.py`` (each beam's KDA
  recurrence over its whole sequence at every step, NoPE MLA, the held
  experts and the shared one), which follows the program's routing near
  ties as ``reference/moonlight.py`` does;
- the costs are ``costs_kimi_linear.py``'s: the retrieve's FLOPs on this
  card, the MLA layers' bound, the held experts' bound from the routing
  counters (``moe_held``), the stack's products' bound
  (``decoder_bound_s_per_unit``, for ``decoder_roofline.serve``) and the
  traced stretch's KDA calls' bound from the program's counters
  (``kda_bound_s``, for ``kda_roofline.serve``);
- the set-up's launch check: ``kda_prefill`` at every KDA layer,
  ``kda_decode`` KDA layers × steps, ``mla_attention`` MLA layers × steps,
  ``topk_expert_sublayer`` at every expert layer once for the prefill and
  once a step, one packed scorer.

``serve_moonlight.py`` names these parts as module globals, so :func:`run`
puts this configuration's in their place while it runs (:func:`kimi`)
and puts Moonlight's back after.  It hands the traced stretch's counters
to the costs' ``topk_expert_bound_s`` alone, so the costs it is given
(:class:`TracedCosts`) keep them, with the host counters read at that
moment, for the KDA bound.
"""

from __future__ import annotations

import contextlib

from gdrbench import costs_kimi_linear
from gdrbench.drivers import serve_moonlight as sm
from gdrbench.drivers.serve import SEED_QUERIES, SEED_WEIGHTS  # noqa: F401
from gdrbench.drivers.serve_moonlight import (CHECKS, _world,  # noqa: F401
                                              numbers, sample)
from gdrbench.reference import kimi_linear as ref_kimi
from gdrbench.traffic.world import sub_seed
from gdrbench.weights_kimi_linear import draw_into


def expected_launches(m: dict, max_len: int) -> dict[str, int]:
    """Kernel launches of one retrieve on the main path."""
    kda = len(m["kda_layers"])
    moe = m["num_layers"] - m["first_k_dense"]
    return {"kda_prefill": kda, "kda_decode": kda * max_len,
            "mla_attention": (m["num_layers"] - kda) * max_len,
            "topk_expert_sublayer": moe * (max_len + 1), "packed_scores": 1}


def build(ctx):
    """(model, its parameters by name) on the run's device."""
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever

    with ctx.device:
        model = GenerativeRetriever(ModelConfig(**ctx.config["model"]))
    return model.eval(), draw_into(model, sub_seed(ctx.seed, SEED_WEIGHTS))


class TracedCosts:
    """``costs_kimi_linear`` that keeps the counters its
    ``topk_expert_bound_s`` is handed (the traced stretch's device
    counters) with the host counters of that moment (``counts``)."""

    def __init__(self):
        self.counts: dict | None = None

    def __getattr__(self, name: str):
        return getattr(costs_kimi_linear, name)

    def topk_expert_bound_s(self, m: dict, stats: dict) -> float:
        from gdr_tpu_torch.utils import timing
        self.counts = {**timing.counts(), **stats}
        return costs_kimi_linear.topk_expert_bound_s(m, stats)


@contextlib.contextmanager
def kimi(costs=costs_kimi_linear):
    """``serve_moonlight.py``'s parts replaced by this configuration's."""
    parts = dict(build=build, expected_launches=expected_launches,
                 costs_moonlight=costs, ref_ds=ref_kimi)
    plain = {k: getattr(sm, k) for k in parts}
    for k, v in parts.items():
        setattr(sm, k, v)
    try:
        yield
    finally:
        for k, v in plain.items():
            setattr(sm, k, v)


def reference_outputs(*args, **kw):
    """``serve_moonlight.reference_outputs`` with the Kimi Linear
    reference (the TF32 control's entry)."""
    with kimi():
        return sm.reference_outputs(*args, **kw)


def run(ctx) -> dict:
    from gdr_tpu_torch.models import kimi_linear  # noqa: F401  (refuses a
    # checkout without the stack at once, before any weights are drawn)

    costs = TracedCosts()
    with kimi(costs):
        out = sm.run(ctx)
    m, ecfg, b = ctx.config["model"], ctx.config["eval"], ctx.traffic["batch"]
    _, max_len = _world(ctx)
    layer = out["layer"]
    layer["decoder_bound_s_per_unit"] = costs_kimi_linear.decoder_bound_s(
        m, b, ecfg["num_beams"], max_len, ctx.config["max_input_length"])
    if costs.counts is not None:
        layer["kda_bound_s"] = costs_kimi_linear.kda_bound_s(
            m, costs.counts, b)
        out["info"]["kda_traced"] = {k: costs.counts[k] for k in (
            "kda_prefill", "kda_decode", "kda_state_rows", "kda_source_rows",
            "kda_prefill_tokens")}
    return out

