"""The routed-expert sublayers' share of their roofline over the traced
retrieves: the bound of the stretch's expert calls (``costs_experts.py``,
from the routing counters zeroed before the stretch: the experts each call
reads, the router, the rows, at 3.35 TB/s or 67 TFLOP/s f32) over the
device time of the ``gdr::moe_`` kernels."""


def read(layer: dict):
    if layer.get("kind") != "serve" or "trace" not in layer \
            or "expert_bound_s" not in layer:
        return None
    t = layer["trace"].device_time(lambda n: "gdr::moe_" in n)
    if t <= 0:
        return None
    return 100.0 * layer["expert_bound_s"] / t
