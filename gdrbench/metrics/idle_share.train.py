"""Share of the traced window in which no operation runs on the card
(rank 0's card over several): one minus the union of the device
operations' intervals over the window."""


def read(layer: dict):
    tr = layer.get("trace")
    if layer.get("kind") != "train" or tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
