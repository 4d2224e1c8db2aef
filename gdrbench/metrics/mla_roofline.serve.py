"""The MLA decode kernel's share of its roofline over the traced
retrieves: the bound of every layer's call at every step
(``costs_moonlight.py``: the prefix keys and values once a query and
head, the rows' projections and cached steps, at 3.35 TB/s, or the FMAs
at 67 TFLOP/s) over the device time of ``gdr::mla_decode``."""


def read(layer: dict):
    if layer.get("kind") != "serve" or "trace" not in layer \
            or "mla_bound_s_per_unit" not in layer:
        return None
    t = layer["trace"].device_time(lambda n: "gdr::mla_decode" in n)
    if t <= 0:
        return None
    return 100.0 * layer["mla_bound_s_per_unit"] * layer["trace_units"] / t
