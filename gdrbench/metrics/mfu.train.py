"""The frozen ``train_step_cost`` FLOPs of the steps the untraced window
completed over the window's seconds × chips × the bf16 peak."""


def read(layer: dict):
    if layer.get("kind") != "train" or not layer.get("units"):
        return None
    return 100.0 * layer["flops_per_unit"] * layer["units"] / (
        layer["window_s"] * layer["chips"] * layer["peak_flops"])
