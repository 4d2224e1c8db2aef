"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and a launch counter.  The device of the tensors decides
which runs: CPU → plain version, CUDA → kernel.  The host-sync counter of
the retrieve path (``utils/timing.py``) is read and reset with the launch
counters."""

from gdr_tpu_torch.kernels import decode, rerank
from gdr_tpu_torch.utils import timing


def reset_launch_counts() -> None:
    """Set every kernel's launch count and the host-sync count to 0."""
    for counts in (decode.LAUNCHES, rerank.LAUNCHES, timing.SYNCS):
        for name in counts:
            counts[name] = 0


def launch_counts(host_syncs: bool = False) -> dict[str, int]:
    """Launches of each kernel since the last reset, by wrapper name; with
    ``host_syncs``, also the host's reads of a device value
    (``"host_syncs"``)."""
    return {**decode.LAUNCHES, **rerank.LAUNCHES,
            **(timing.SYNCS if host_syncs else {})}
