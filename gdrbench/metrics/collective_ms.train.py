"""NCCL kernels' device time on rank 0 per traced step: the dp gradient
all-reduce and every other collective of the step."""


def read(layer: dict):
    tr = layer.get("trace")
    if layer.get("kind") != "train" or tr is None or layer.get("chips", 1) < 2:
        return None
    t = tr.device_time(lambda n: "nccl" in n.lower())
    if t <= 0:
        return None
    return 1e3 * t / layer["trace_units"]
