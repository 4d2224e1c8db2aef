"""The top-k routed-expert kernels' share of their roofline over the traced
retrieves: the bound of the stretch's expert calls
(``costs_moonlight.py``, from the routing counters zeroed before the
stretch: each hit expert's 3·d·d_ff f32 once, the router, the rows, at
3.35 TB/s, or the FMAs at 67 TFLOP/s) over the device time of the
``gdr::moe_`` kernels."""


def read(layer: dict):
    if layer.get("kind") != "serve" or "trace" not in layer \
            or "topk_expert_bound_s" not in layer:
        return None
    t = layer["trace"].device_time(lambda n: "gdr::moe_" in n)
    if t <= 0:
        return None
    return 100.0 * layer["topk_expert_bound_s"] / t
