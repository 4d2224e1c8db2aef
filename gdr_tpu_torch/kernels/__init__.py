"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version.  The device of the tensors decides which runs: CPU →
plain version, CUDA → kernel.  Each kernel module declares its wrappers'
launch counters in the registry of ``utils/timing.py``; the routed
experts' routing counters and KDA's source rows and prefill tokens live on
the device (``experts.py``, ``kda.py``)."""

from gdr_tpu_torch.kernels import decode, kda, mla, rerank
from gdr_tpu_torch.kernels import experts as _experts
from gdr_tpu_torch.utils import timing

_WRAPPERS = (decode.WRAPPERS + rerank.WRAPPERS + _experts.WRAPPERS
             + mla.WRAPPERS + kda.WRAPPERS)


def reset_launch_counts() -> None:
    """Set every counter of the registry and the device counters to 0."""
    timing.restore(dict.fromkeys(timing.counts(), 0))
    _experts.reset_stats()
    kda.reset_stats()


def launch_counts(experts: bool = False) -> dict[str, int]:
    """Launches of each kernel since the last reset, by wrapper name; with
    ``experts``, also the device counters: the routing counters ``moe_*``
    and KDA's ``kda_source_rows``, ``kda_prefill_tokens`` (one sync
    each).  ``timing.counts()`` reads the launches with the host syncs and
    the CUDA graph counters."""
    every = timing.counts()
    out = {name: every[name] for name in _WRAPPERS}
    if experts:
        out.update(_experts.read_stats())
        out.update(kda.read_stats())
    return out
