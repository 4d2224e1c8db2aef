"""Device kernel launches in the trace over the steps traced (rank 0)."""


def read(layer: dict):
    tr = layer.get("trace")
    if layer.get("kind") != "train" or tr is None or not tr.kernels:
        return None
    return tr.kernels / layer["trace_units"]
