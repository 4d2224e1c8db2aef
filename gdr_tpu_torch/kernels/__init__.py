"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and a launch counter.  The device of the tensors decides
which runs: CPU → plain version, CUDA → kernel.  The host-sync and CUDA
graph counters of the retrieve path (``utils/timing.py``), the routed
experts' device counters (``experts.py``) and the f32 GEMM's launches by
kernel (``decode.GEMM_PATHS``) are read and reset with the launch
counters."""

from gdr_tpu_torch.kernels import decode, rerank
from gdr_tpu_torch.kernels import experts as _experts
from gdr_tpu_torch.utils import timing

_LAUNCHES = (decode.LAUNCHES, rerank.LAUNCHES, _experts.LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's launch count, the host-sync count, the CUDA
    graph counts, the GEMM's launches by kernel and the experts' routing
    counters to 0."""
    for counts in (*_LAUNCHES, decode.GEMM_PATHS, timing.SYNCS,
                   timing.GRAPHS):
        for name in counts:
            counts[name] = 0
    _experts.reset_stats()


def launch_counts(host_syncs: bool = False, graphs: bool = False,
                  experts: bool = False,
                  gemm_paths: bool = False) -> dict[str, int]:
    """Launches of each kernel since the last reset, by wrapper name; with
    ``host_syncs``, also the host's reads of a device value
    (``"host_syncs"``); with ``graphs``, also the decode's CUDA graph
    pieces captured and replayed and its eager CUDA decodes; with
    ``experts``, also the routing counters ``moe_*`` (read from the
    device, one sync); with ``gemm_paths``, also the sublayers' f32 GEMM
    launches by kernel (``gemm_f32_rows``, ``gemm_f32_ring``)."""
    out = {k: v for table in _LAUNCHES for k, v in table.items()}
    if gemm_paths:
        out.update(decode.GEMM_PATHS)
    if host_syncs:
        out.update(timing.SYNCS)
    if graphs:
        out.update(timing.GRAPHS)
    if experts:
        out.update(_experts.read_stats())
    return out


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name, and the GEMM's by kernel) to the
    launch counters: a replayed CUDA graph launches its kernels without
    calling their wrappers."""
    for table in (*_LAUNCHES, decode.GEMM_PATHS):
        for name in counts.keys() & table.keys():
            table[name] += counts[name]
