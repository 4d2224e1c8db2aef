"""The KDA kernels' device time (the port's ``gdr::kda_`` kernels: the
prefill and the decode steps) per traced retrieve, in ms."""


def read(layer: dict):
    if layer.get("kind") != "serve" or "trace" not in layer:
        return None
    t = layer["trace"].device_time(lambda n: "gdr::kda_" in n)
    if t <= 0:
        return None
    return 1e3 * t / layer["trace_units"]
