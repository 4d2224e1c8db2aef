"""Multi-process bootstrap, mirroring ``gdr_tpu/parallel/distributed.py``.

JAX runs one controller per host and ``jax.distributed.initialize()``
joins them.  PyTorch runs one process per GPU, as ``torchrun`` launches
them, joined by a ``torch.distributed`` process group: ``nccl`` for ranks
on CUDA devices, ``gloo`` for ranks on the CPU.  The backend is named when
the group is made, never tried after a failure.  Each ``nccl`` rank takes
its card before the group is made: ``LOCAL_RANK`` where ``torchrun`` set
it, else its process id modulo the host's cards (explicit arguments
number the processes host by host, one per card).

    torchrun --nproc-per-node 4 -m gdr_tpu_torch.cli retrieve --mesh 4 ...
    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-endpoint HOST:PORT ...
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# a rank that never arrives fails the others after this, not a hang
TIMEOUT = timedelta(seconds=120)
# what torchrun sets for each rank
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
# the mesh's subgroups, made once per (dp, mp) shape and destroyed by
# ``shutdown``: (the dp column of each mp coordinate, the mp row of each
# dp coordinate)
_SUBGROUPS: dict[tuple[int, int], tuple[list, list]] = {}


def local_card(rank: int, world: int, cards: int) -> tuple[int, int]:
    """(this rank's card, ranks on its host) for ``nccl``: torchrun's
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` where set, else one process per
    card numbered host by host (``rank % cards``; a world of at most
    ``cards`` is one host).  Raises ValueError when the ranks of a host
    outnumber its cards: NCCL needs one card per rank."""
    env = os.environ
    local = int(env.get("LOCAL_RANK", rank % cards if cards else 0))
    per_host = int(env.get("LOCAL_WORLD_SIZE",
                           world if not cards or world % cards else cards))
    if per_host > cards:
        raise ValueError(
            f"{per_host} ranks on this host over nccl, but {cards} CUDA "
            f"device(s): NCCL needs one card per rank; start at most "
            f"{cards} a host (or use gloo on the CPU)")
    return local, per_host


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the default process group when running in several processes.

    Explicit: ``coordinator_address`` (``host:port`` or ``tcp://host:port``,
    rank 0's address), ``num_processes`` and ``process_id``.  Otherwise the
    environment that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; any one of them is taken to mean
    torchrun, and a missing other raises).  With neither it returns False:
    the single-process case.  ``backend``: ``nccl`` (one card per rank) or
    ``gloo``; by default ``nccl`` where CUDA is available.  A join that
    fails raises (ValueError for too many ranks on a host's cards).
    Returns True once the group exists."""
    if dist.is_initialized():
        return True
    explicit = coordinator_address is not None
    if not explicit and not any(v in os.environ for v in TORCHRUN_ENV):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator address needs "
                             "num_processes and process_id")
        addr = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        kwargs = dict(init_method=addr, world_size=num_processes,
                      rank=process_id)
        rank, world = process_id, num_processes
    else:
        kwargs = dict(init_method="env://")
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
    if backend == "nccl":
        card, _ = local_card(rank, world, torch.cuda.device_count())
        torch.cuda.set_device(card)
        kwargs["device_id"] = torch.device("cuda", card)
    dist.init_process_group(backend, timeout=TIMEOUT, **kwargs)
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def subgroups(dp: int, mp: int) -> tuple[list, list]:
    """(dp columns, mp rows) of a dp × mp mesh over the default group:
    column ``c`` holds ranks ``c, c + mp, …`` (one mp coordinate), row
    ``d`` ranks ``d·mp … d·mp + mp − 1``.  Made on the first call for a
    shape, which every rank must make at the same point (``make_mesh``
    does); later calls return the same groups.  Nobody else keeps them:
    ``shutdown`` destroys them before the default group, so that no group
    outlives it."""
    key = (dp, mp)
    if key not in _SUBGROUPS:
        cols = [dist.new_group(list(range(c, dp * mp, mp)), timeout=TIMEOUT)
                for c in range(mp)]
        rows = [dist.new_group(list(range(d * mp, (d + 1) * mp)),
                               timeout=TIMEOUT) for d in range(dp)]
        _SUBGROUPS[key] = (cols, rows)
    return _SUBGROUPS[key]


def shutdown() -> None:
    """Leave the default process group, where one exists, after the
    mesh's subgroups."""
    if dist.is_initialized():
        for cols, rows in _SUBGROUPS.values():
            for g in cols + rows:
                dist.destroy_process_group(g)
        _SUBGROUPS.clear()
        dist.destroy_process_group()
