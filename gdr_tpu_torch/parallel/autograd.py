"""Differentiable collectives over a mesh's dp column, for the losses that
couple the rows of a batch (``ops/losses.py``) when each dp rank holds a
slice of the global batch.

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
"""

from __future__ import annotations

import torch


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
