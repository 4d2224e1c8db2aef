"""The dp × mp mesh of ranks, mirroring ``make_mesh`` and
``store_sharding`` of ``gdr_tpu/parallel/mesh.py``.

JAX lays the mesh over devices and XLA inserts its collectives.  Here the
mesh is laid over the ranks of the process group, one per GPU, rank ``r``
at (``r // mp``, ``r % mp``), and the collectives are explicit.  The
doc-embedding store is row-sharded over the flattened mesh: shard ``r``
is rank ``r``'s.  Collectives run on ``comm_device``: the rank's card under
``nccl``, the CPU under ``gloo``, which also serves several ranks that
share one card (NCCL refuses two ranks on one device).

The training side (``batch_sharding``, ``shard_batch``,
``tp_param_rules``, ``shard_params``) is not ported yet (ROADMAP.md queue
1, item 11).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from gdr_tpu_torch.config import MeshConfig


@dataclass
class Mesh:
    """The mesh over the default process group.  It holds no reference to
    the group: a group object still referenced when
    ``distributed.shutdown`` destroys it is torn down again at interpreter
    exit, which aborted ``gloo`` ranks there (3 of 160 two-rank runs on a
    loaded CPU host with torch 2.13; none of 150 without the reference)."""

    dp: int
    mp: int
    rank: int
    world: int
    device: torch.device         # where this rank computes
    comm_device: torch.device    # where its collectives run

    @property
    def size(self) -> int:
        """Shards of the store: every rank of the mesh."""
        return self.dp * self.mp

    def store_range(self, n_rows: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of a store of ``n_rows`` rows padded
        to a multiple of the mesh size (``parallel/store.py::pad_store``)."""
        rows = -(-n_rows // self.size)
        return self.rank * rows, (self.rank + 1) * rows

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every rank, concatenated along the last axis in rank
        order (the reference's ``all_gather(axis=-1, tiled=True)``), on
        ``t``'s device; ``t`` itself without a process group.  Every rank
        passes the same shape."""
        if not dist.is_initialized():
            return t
        src = t.to(self.comm_device).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return torch.cat(parts, dim=-1).to(t.device)


def make_mesh(cfg: MeshConfig | None = None, device=None) -> Mesh:
    """The mesh over the default process group (a world of one without
    one).  ``dp=-1`` takes every rank; ``dp·mp`` must equal the world.
    ``device``: where this rank computes (default: its card under
    ``nccl``, else the CPU)."""
    cfg = cfg or MeshConfig()
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    mp = max(cfg.mp, 1)
    dp = cfg.dp if cfg.dp > 0 else world // mp
    if dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} != {world} processes")
    comm = (torch.device("cuda", torch.cuda.current_device())
            if backend == "nccl" else torch.device("cpu"))
    return Mesh(dp=dp, mp=mp, rank=rank, world=world,
                device=torch.device(device) if device is not None else comm,
                comm_device=comm)
