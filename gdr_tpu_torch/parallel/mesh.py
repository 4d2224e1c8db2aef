"""The dp × mp mesh of ranks, mirroring ``gdr_tpu/parallel/mesh.py``.

JAX lays the mesh over devices and XLA inserts its collectives.  Here the
mesh is laid over the ranks of the process group, one per GPU, rank ``r``
at (``dp_rank = r // mp``, ``mp_rank = r % mp``), and the collectives are
explicit.  Collectives run on ``comm_device``: the rank's card under
``nccl``, the CPU under ``gloo``, which also serves several ranks that
share one card (NCCL refuses two ranks on one device).

Serving: the doc-embedding store is row-sharded over the flattened mesh;
shard ``r`` is rank ``r``'s (``store_range``, ``parallel/store.py``).

Training (``train/loop.py::TrainLoop(mesh=)``): every rank builds the same
global batch and keeps its dp rows (:func:`shard_batch`); the mp ranks of
a dp coordinate take the same rows.  The placement is ``gdr_tpu``'s
column-parallel one (:func:`tp_param_rules`): a leaf whose flax shape has
2+ axes, ``tp_min_size``+ elements and a last axis that divides by mp is
cut on that axis, which is the output axis of a Dense kernel; the port's
tensor holds it on the dim ``convert.py::flax_layout`` names (dim 0 of a
Linear weight ``[out, in]``, the q, k and v blocks of the fused ``qkv``).
An mp rank holds its part of such a leaf as its f32 master, its AdamW
moments and its compute copy (:func:`shard_params`), and computes only its
columns of each product over it, forward and backward
(``parallel/autograd.py``): the ranks of an mp row split the step's
compute.  The gradients of the parts are summed over each dp column
(:meth:`Mesh.all_reduce_dp`); the activations cross the mp row
(:meth:`Mesh.all_gather_mp`, :meth:`Mesh.sum_mp`).  The library form of
``gdr_tpu``'s ``examples/demo_mesh_train.py``, one process per GPU:

    # torchrun --nproc-per-node 4 train.py
    from gdr_tpu_torch.parallel.distributed import initialize, shutdown
    initialize()
    loop = TrainLoop(cfg, index, train_set, dev, workdir,
                     mesh=make_mesh(MeshConfig(dp=2, mp=2)))
    loop.run()
    shutdown()
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gdr_tpu_torch.config import MeshConfig
from gdr_tpu_torch.convert import flax_layout
from gdr_tpu_torch.parallel.distributed import subgroups

# elements of f32 gradient that one all-reduce carries (256 MB)
BUCKET = 1 << 26


@dataclass
class Mesh:
    """The mesh over the default process group.  It holds no reference to
    a group: a group object still referenced when
    ``distributed.shutdown`` destroys it is torn down again at interpreter
    exit, which aborted ``gloo`` ranks there (3 of 160 two-rank runs on a
    loaded CPU host with torch 2.13; none of 150 without the reference).
    Its subgroups are looked up in ``distributed.subgroups`` at each
    collective."""

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

    @property
    def dp_rank(self) -> int:
        return self.rank // self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp

    def store_range(self, n_rows: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of a store of ``n_rows`` rows padded
        to a multiple of the mesh size (``parallel/store.py::pad_store``)."""
        rows = -(-n_rows // self.size)
        return self.rank * rows, (self.rank + 1) * rows

    # ------------------------------------------------------- collectives

    def _group(self, axis: str):
        """The group of this rank's dp column or mp row (None: the whole
        world, where the axis spans it)."""
        if axis == "world":
            return None
        if not dist.is_initialized():
            raise RuntimeError(f"a {self.dp}x{self.mp} mesh collective "
                               f"without a process group")
        cols, rows = ((None, None) if self.dp == 1 or self.mp == 1
                      else subgroups(self.dp, self.mp))
        if axis == "dp":
            return None if self.mp == 1 else cols[self.mp_rank]
        return None if self.dp == 1 else rows[self.dp_rank]

    def _size(self, axis: str) -> int:
        return {"world": self.world, "dp": self.dp, "mp": self.mp}[axis]

    def _gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """``t`` of every rank of ``axis`` (``world``, ``dp`` or ``mp``),
        concatenated along ``dim`` in rank order, on ``t``'s device."""
        n = self._size(axis)
        if n == 1:
            return t
        src = t.to(self.comm_device).contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axis))
        return torch.cat(parts, dim=dim).to(t.device)

    def _sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        if self._size(axis) == 1:
            return t
        out = t.detach().to(self.comm_device).clone()
        dist.all_reduce(out, group=self._group(axis))
        return out.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every rank, concatenated along the last axis in rank
        order (the reference's ``all_gather(axis=-1, tiled=True)``); ``t``
        itself in a world of one.  Every rank passes the same shape."""
        return self._gather(t, "world", -1)

    def all_gather_dp(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every rank of this rank's dp column, concatenated along
        the first axis in dp order: the global batch's rows."""
        return self._gather(t, "dp", 0)

    def all_gather_mp(self, t: torch.Tensor, dim: int = -1,
                      blocks: int = 1) -> torch.Tensor:
        """The parts of every rank of this rank's mp row made whole along
        ``dim``: a cut leaf or activation (:class:`Cut`).  ``blocks``: the
        dim is that many contiguous blocks, each cut into mp parts, and
        ``t`` holds this rank's part of each block in block order."""
        whole = self._gather(t, "mp", dim)
        if blocks == 1 or self.mp == 1:
            return whole
        dim = dim % t.dim()
        c = t.shape[dim] // blocks
        return whole.unflatten(dim, (self.mp, blocks, c)).transpose(
            dim, dim + 1).flatten(dim, dim + 2)

    def sum_mp(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM of ``t`` over this rank's mp row (a new tensor): a
        contraction whose axis the row cuts, completed."""
        return self._sum(t, "mp")

    def all_reduce_dp(self, tensors: list[torch.Tensor]) -> None:
        """SUM each tensor in place over this rank's dp column, in buckets
        of at most :data:`BUCKET` elements of one dtype."""
        if self.dp == 1:
            return
        group = self._group("dp")
        bucket: list[torch.Tensor] = []

        def flush():
            flat = torch.cat([t.reshape(-1) for t in bucket]).to(
                self.comm_device)
            dist.all_reduce(flat, group=group)
            flat = flat.to(bucket[0].device)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
            bucket.clear()

        size = 0
        for t in tensors:
            if bucket and (size + t.numel() > BUCKET
                           or t.dtype != bucket[0].dtype):
                flush()
                size = 0
            bucket.append(t)
            size += t.numel()
        if bucket:
            flush()

    def sum_dp(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM of ``t`` over this rank's dp column (a new tensor): a
        count or a metric of the global batch."""
        return self._sum(t, "dp")

    def sum_world(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM of ``t`` over every rank (a new tensor)."""
        return self._sum(t, "world")

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank: a decision every rank
        takes alike (a preemption stop)."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def make_mesh(cfg: MeshConfig | None = None, device=None) -> Mesh:
    """The mesh over the default process group (a world of one without
    one).  ``dp=-1`` takes every rank; ``dp·mp`` must equal the world.
    ``device``: where this rank computes (default: its card under
    ``nccl``, else the CPU).  Every rank calls it at the same point: a
    mesh of dp and mp both above 1 makes its subgroups here."""
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
    if dp > 1 and mp > 1:
        subgroups(dp, mp)
    return Mesh(dp=dp, mp=mp, rank=rank, world=world,
                device=torch.device(device) if device is not None else comm,
                comm_device=comm)


# ------------------------------------------------------------- training

def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global host batch: rows ``[dp_rank·B/dp,
    (dp_rank+1)·B/dp)`` of every field, the same on each mp rank of the
    row.  Every rank builds the same global batch (the iterators are seeded
    alike), as ``gdr_tpu``'s ``shard_batch`` materialises only a process's
    addressable shards."""
    out = {}
    for k, v in batch.items():
        b = len(v) // mesh.dp
        out[k] = v[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
    return out


class Cut(NamedTuple):
    """Where a leaf is cut over mp: port ``dim``, made of ``blocks``
    contiguous blocks that are each cut into mp equal parts (the fused
    ``qkv`` is 3 blocks, q, k and v; ``convert.py::flax_layout``)."""

    dim: int
    blocks: int = 1


def tp_param_rules(mp: int, min_size: int = 1 << 14,
                   doc_heads: int = 0) -> Callable:
    """The column-parallel placement rule of ``gdr_tpu``: a leaf whose
    *flax* shape has at least 2 axes and ``min_size`` elements and whose
    last axis divides by ``mp`` is cut on that axis; everything else stays
    whole.  ``rule(name, leaf) -> Cut | None``, ``name`` is ``<tower>/<port
    name>`` (``doc_heads``: the doc tower's heads).  A routed FFN's leaves
    (router and stacked experts) have no placement: the rule raises."""

    def rule(name: str, leaf: Any) -> Cut | None:
        if not isinstance(leaf, torch.Tensor):
            return None
        tower, _, pname = name.rpartition("/")
        if pname.endswith((".ff.router", ".ff.wi", ".ff.wo")):
            raise NotImplementedError(
                f"{pname}: sparse experts have no column-parallel placement")
        shape, dim, blocks = flax_layout(
            pname, leaf.shape, doc_heads if tower == "doc_encoder" else 0)
        if (len(shape) >= 2 and int(np.prod(shape)) >= min_size
                and shape[-1] % mp == 0):
            return Cut(dim, blocks)
        return None

    return rule


def mp_slice(t: torch.Tensor, mesh: Mesh, cut: Cut) -> torch.Tensor:
    """This rank's part of ``t`` cut as ``cut`` says: the ``mp_rank``-th of
    mp equal parts of each block of ``cut.dim``, in block order (a view)."""
    dim = cut.dim % t.dim()
    c = t.shape[dim] // (cut.blocks * mesh.mp)
    return t.unflatten(dim, (cut.blocks, mesh.mp, c)).select(
        dim + 1, mesh.mp_rank).flatten(dim, dim + 1)


def shard_params(params: Any, mesh: Mesh, rule: Callable | None = None,
                 name: str = "") -> tuple[Any, dict[str, Cut]]:
    """A (nested) dict of tensors with each leaf that ``rule`` selects cut
    to this rank's part (:func:`mp_slice`, a copy of its own); other leaves,
    and everything without ``rule`` or at mp = 1, stay whole.  Returns
    (the dict, ``{name: Cut}`` of the cut leaves by ``/``-joined name)."""
    cuts: dict[str, Cut] = {}

    def place(node, path):
        if isinstance(node, dict):
            return {k: place(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        cut = rule(path, node) if rule is not None and mesh.mp > 1 else None
        if cut is None:
            return node
        cuts[path] = cut
        return mp_slice(node, mesh, cut).clone()

    return place(params, name), cuts


def unshard_params(params: Any, cuts: dict[str, Cut], mesh: Mesh,
                   device=None, name: str = "") -> Any:
    """The inverse of :func:`shard_params`: each leaf named in ``cuts`` is
    gathered over this rank's mp row, and with ``device`` every leaf is
    moved there leaf by leaf.  Every rank of the row calls it."""
    if isinstance(params, dict):
        return {k: unshard_params(v, cuts, mesh, device,
                                  f"{name}/{k}" if name else k)
                for k, v in params.items()}
    cut = cuts.get(name)
    if cut is not None:
        params = mesh.all_gather_mp(params, cut.dim, cut.blocks)
    return params if device is None else params.to(device)


def fetch_rows(store_local: torch.Tensor, ids: np.ndarray, mesh: Mesh
               ) -> torch.Tensor:
    """``store[ids]`` of a row-sharded store (``parallel/store.py::
    place_store``; every rank passes the same ``ids``): each rank fills the
    rows it owns and zeros elsewhere, then one SUM over every rank.  Exact:
    exactly one rank adds a non-zero to each row.  [*ids.shape, d] f32 on
    the store's device."""
    rows = store_local.shape[0]
    flat = torch.as_tensor(np.asarray(ids).reshape(-1),
                           device=store_local.device).long()
    local = flat - mesh.rank * rows
    owned = (local >= 0) & (local < rows)
    out = torch.zeros(len(flat), store_local.shape[1],
                      device=store_local.device)
    out[owned] = store_local[local[owned]].float()
    return mesh.sum_world(out).reshape(*np.shape(ids), -1)
