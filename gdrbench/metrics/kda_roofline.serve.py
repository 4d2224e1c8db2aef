"""The KDA kernels' share of their roofline over the traced retrieves: the
bound of the stretch's KDA calls (``costs_kimi_linear.py``, from the
program's counters zeroed before the stretch: each distinct source row's
recurrent state and convolution window read once and every row's written,
the rows' projections in and outputs out, the prefills' real tokens, at
3.35 TB/s, or the FLOPs at 67 TFLOP/s) over the device time of the
``gdr::kda_`` kernels."""


def read(layer: dict):
    if layer.get("kind") != "serve" or "trace" not in layer \
            or "kda_bound_s" not in layer:
        return None
    t = layer["trace"].device_time(lambda n: "gdr::kda_" in n)
    if t <= 0:
        return None
    return 100.0 * layer["kda_bound_s"] / t
