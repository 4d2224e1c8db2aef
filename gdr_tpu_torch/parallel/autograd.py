"""Differentiable collectives over a mesh's dp column and mp row.

Over the dp column, for the losses that couple the rows of a batch
(``ops/losses.py``) when each dp rank holds a slice of the global batch:

- :func:`gather_dp`: forward, the dp column's rows concatenated in dp order
  (:meth:`Mesh.all_gather_dp`); backward, the SUM over the column of the
  whole gathered gradient, then this rank's rows.  Every rank's loss reads
  every rank's rows, so the gradient of the global loss at rank ``r``'s
  rows is the sum of each rank's gradient at them.
- :func:`sum_dp`: forward and backward a SUM over the column (the global
  normaliser of a masked mean; a count carries no gradient and runs no
  backward).

``torch.distributed.nn.functional.all_gather`` runs ``all_to_all`` in its
backward on any backend but NCCL, which ``gloo`` lacks, so these are the
port's own.  :class:`DPShards` hands them to the losses.

Over the mp row, for the column-parallel step (``gdr_tpu``'s placement,
``parallel/mesh.py``): each rank holds its part of a cut leaf and computes
only its part of each product over it.  An activation outside those
products is replicated: every rank of the row holds the same bits.

- :func:`copy_to_mp`: forward the identity, backward the SUM over the row:
  a replicated activation entering a rank's part of a product, whose
  gradient each rank holds only in part;
- :func:`gather_from_mp`: forward the parts made whole on the cut dim,
  backward this rank's part of the gradient;
- :func:`reduce_from_mp`: forward the SUM over the row in f32 (a
  contraction over a cut axis completed), backward the identity.

Every SUM over the row runs in f32 and is cast once.  Built from them:
:func:`column_linear` (``y = x·W_rᵀ``, then a gather: ``dW_r = dy_rᵀ·x``
stays local and ``dx`` is the row's SUM of ``dy_r·W_r``) and
:func:`mp_part` (this rank's part of a replicated activation, for a
contraction over a cut axis).  A module whose leaf is cut reads the mesh
from its ``mp_mesh``, which :func:`set_mp_mesh` sets for the step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gdr_tpu_torch.parallel.mesh import Cut, mp_slice


class _GatherDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.rows = x.shape[0]
        return mesh.all_gather_dp(x)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = grad.contiguous().clone()
        mesh.all_reduce_dp([grad])
        r = mesh.dp_rank * ctx.rows
        return grad[r:r + ctx.rows], None


class _SumDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.sum_dp(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.sum_dp(grad), None


def gather_dp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rows of every rank of ``mesh``'s dp column, differentiably."""
    if mesh.dp == 1:
        return x
    return _GatherDP.apply(x, mesh)


def sum_dp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The SUM of ``x`` over ``mesh``'s dp column, differentiably."""
    if mesh.dp == 1:
        return x
    return _SumDP.apply(x, mesh)


class DPShards:
    """What a batch-coupled loss needs of the dp column: ``rank`` and
    ``size`` (this rank's dp coordinate and dp), ``gather(x)`` (every
    rank's rows in dp order, differentiable) and ``total(x)`` (the SUM
    over the column, differentiable)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.rank = mesh.dp_rank
        self.size = mesh.dp

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_dp(x, self.mesh)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return sum_dp(x, self.mesh)


# ------------------------------------------------------------- the mp row

class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.sum_mp(grad.float()).to(grad.dtype), None


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, blocks):
        ctx.mesh = mesh
        ctx.cut = Cut(dim, blocks)
        return mesh.all_gather_mp(x, dim, blocks)

    @staticmethod
    def backward(ctx, grad):
        return (mp_slice(grad, ctx.mesh, ctx.cut).contiguous(), None, None,
                None)


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.dtype = x.dtype
        return mesh.sum_mp(x.float())

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_mp(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` itself; in the backward the SUM of its gradient over ``mesh``'s
    mp row."""
    return _CopyToMP.apply(x, mesh)


def gather_from_mp(x: torch.Tensor, mesh, dim: int = -1,
                   blocks: int = 1) -> torch.Tensor:
    """Every mp rank's part of ``x`` made whole on ``dim``
    (:meth:`Mesh.all_gather_mp`); in the backward this rank's part."""
    return _GatherFromMP.apply(x, mesh, dim, blocks)


def reduce_from_mp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The f32 SUM of ``x`` over ``mesh``'s mp row; in the backward the
    gradient itself."""
    return _ReduceFromMP.apply(x, mesh)


def column_linear(x: torch.Tensor, w: torch.Tensor, mesh, blocks: int = 1,
                  gather: bool = True) -> torch.Tensor:
    """``F.linear`` of the replicated ``x`` by this rank's rows ``w`` of a
    weight cut on its output dim (in ``blocks``): the whole output, or with
    ``gather=False`` this rank's columns of it."""
    y = F.linear(copy_to_mp(x, mesh), w)
    return gather_from_mp(y, mesh, -1, blocks) if gather else y


def embedding(module: torch.nn.Module, table: torch.nn.Embedding,
              ids: torch.Tensor) -> torch.Tensor:
    """``table(ids)`` of ``module``'s table; where the table holds this
    rank's columns, looked up there and gathered over the module's mesh."""
    if table.weight.shape[1] == table.embedding_dim:
        return table(ids)
    mesh = mp_mesh(module)
    return gather_from_mp(F.embedding(ids, table.weight), mesh)


def mp_part(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """This rank's part of the replicated ``x`` on ``dim``: its operand of a
    contraction over a cut axis.  The gradients of the parts are summed over
    the row, which makes the replicated gradient whole."""
    x = copy_to_mp(x, mesh)
    n = x.shape[dim] // mesh.mp
    return x.narrow(dim, mesh.mp_rank * n, n)


def mp_mesh(module: torch.nn.Module):
    """The mesh of ``module``, one of whose leaves holds an mp part: its
    ``mp_mesh``, which the train step sets.  Raises without one: a cut
    leaf outside the step is a model whose weights were not made whole."""
    mesh = module.mp_mesh
    if mesh is None:
        raise RuntimeError(
            f"{type(module).__name__} holds an mp part of a leaf but has no "
            f"mesh: outside the train step its weights must be whole")
    return mesh


def set_mp_mesh(module: torch.nn.Module, mesh) -> None:
    """Every submodule of ``module`` that computes over cut leaves reads
    ``mesh`` (None: none)."""
    for m in module.modules():
        if hasattr(type(m), "mp_mesh"):
            m.mp_mesh = mesh
