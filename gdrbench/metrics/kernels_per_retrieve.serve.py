"""Device kernel launches in the trace over the retrieves traced."""


def read(layer: dict):
    tr = layer.get("trace")
    if layer.get("kind") != "serve" or tr is None or not tr.kernels:
        return None
    return tr.kernels / layer["trace_units"]
