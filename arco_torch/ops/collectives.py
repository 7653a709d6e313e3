"""Differentiable collectives over torch.distributed, for the code that
takes a quantity of the whole batch while each rank holds a shard of it
(models/layers.py's BatchNorm statistics, losses/supervised.py's sums)."""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; its backward sums the gradients the same
    way, so a term that every rank computes from the global sums sends each
    rank's input its share of every rank's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable. Every
    rank then holds the same value, and the gradient it sends back is
    ``world size`` times its part of the global one, which the caller's
    gradient average (parallel.mesh.average_gradients) divides out."""
    return _AllReduceSum.apply(x, group)
