"""The routed-expert kernels' device time (the port's ``gdr::moe_``
kernels) per traced retrieve, in ms."""


def is_expert_kernel(name: str) -> bool:
    return "gdr::moe_" in name


def read(layer: dict):
    if layer.get("kind") != "serve" or "trace" not in layer:
        return None
    t = layer["trace"].device_time(is_expert_kernel)
    if t <= 0:
        return None
    return 1e3 * t / layer["trace_units"]
