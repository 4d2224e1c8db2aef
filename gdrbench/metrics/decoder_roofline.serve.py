"""The decoder sublayers' share of their roofline over the traced
retrieves: the sum of every sublayer call's bound (``costs.py``, f32 at
67 TFLOP/s and 3.35 TB/s, from each call's rows, position and cache
length) over the summed device time of the sublayer kernels in the trace
(the port's ``gdr::`` kernels other than the re-rank scorers)."""

KERNELS = ("rms_norm", "gemm_wgmma", "gemm_f32_ring", "self_attn_core",
           "cross_attn_core", "cross_attn_stream", "cross_attn_tiled")


def is_decoder_kernel(name: str) -> bool:
    return "gdr::" in name and any(k in name for k in KERNELS)


def read(layer: dict):
    if layer.get("kind") != "serve" or "trace" not in layer:
        return None
    t = layer["trace"].device_time(is_decoder_kernel)
    if t <= 0:
        return None
    return 100.0 * layer["decoder_bound_s_per_unit"] * layer["trace_units"] / t
