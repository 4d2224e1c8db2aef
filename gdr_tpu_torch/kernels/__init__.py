"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and a launch counter.  The device of the tensors decides
which runs: CPU → plain version, CUDA → kernel.  The host-sync and CUDA
graph counters of the retrieve path (``utils/timing.py``) are read and
reset with the launch counters."""

from gdr_tpu_torch.kernels import decode, rerank
from gdr_tpu_torch.utils import timing


def reset_launch_counts() -> None:
    """Set every kernel's launch count, the host-sync count and the CUDA
    graph counts to 0."""
    for counts in (decode.LAUNCHES, rerank.LAUNCHES, timing.SYNCS,
                   timing.GRAPHS):
        for name in counts:
            counts[name] = 0


def launch_counts(host_syncs: bool = False,
                  graphs: bool = False) -> dict[str, int]:
    """Launches of each kernel since the last reset, by wrapper name; with
    ``host_syncs``, also the host's reads of a device value
    (``"host_syncs"``); with ``graphs``, also the decode's CUDA graph
    pieces captured and replayed and its eager CUDA decodes."""
    return {**decode.LAUNCHES, **rerank.LAUNCHES,
            **(timing.SYNCS if host_syncs else {}),
            **(timing.GRAPHS if graphs else {})}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the launch counters: a replayed
    CUDA graph launches its kernels without calling their wrappers."""
    for table in (decode.LAUNCHES, rerank.LAUNCHES):
        for name in counts.keys() & table.keys():
            table[name] += counts[name]
