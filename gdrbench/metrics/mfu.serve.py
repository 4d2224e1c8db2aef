"""Model FLOPs of the retrieves the untraced window completed
(``costs.retrieve_flops``) over the window's seconds × the f32 peak."""


def read(layer: dict):
    if layer.get("kind") != "serve" or not layer.get("units"):
        return None
    return 100.0 * layer["flops_per_unit"] * layer["units"] / (
        layer["window_s"] * layer["peak_flops"])
