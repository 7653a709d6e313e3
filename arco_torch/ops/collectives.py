"""Differentiable collectives over torch.distributed, for the code that
takes a quantity of the whole batch while each rank holds a shard of it
(models/layers.py's BatchNorm statistics, the losses' sums), and the
layout of the stage-2 step's sharded batch (``BatchShard``).

The collectives here are ``all_reduce`` and ``all_gather_into_tensor``,
which torch's gloo takes on CUDA tensors as NCCL does (gloo has no
send/recv on CUDA tensors), so one code path serves gloo ranks on the
CPU or on one card and NCCL ranks."""

from __future__ import annotations

from dataclasses import dataclass

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


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` [b, ...] stacked in rank order, [n * b, ...], on
    every rank. Not differentiable."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


@dataclass(frozen=True)
class BatchShard:
    """This rank's place in a stage-2 batch split over ``group``: each
    rank holds ``b_l`` labeled then ``b_u`` unlabeled samples, rank r the
    r-th block of each part. The global batch is every rank's labeled
    samples in rank order, then every rank's unlabeled ones (JAX's
    ``cat([labeled, unlabeled])`` over the whole batch)."""
    group: object
    rank: int
    world: int
    b_l: int
    b_u: int

    def sum(self, x):
        """``all_reduce_sum`` over the group (differentiable)."""
        return all_reduce_sum(x, self.group)

    def gather(self, x):
        """[b, ...] of one part -> [world * b, ...] of that part."""
        return all_gather_rows(x, self.group)

    def gather_lu(self, x):
        """A tensor over the local [labeled, unlabeled] rows -> the same
        over the global [labeled, unlabeled] rows."""
        return torch.cat([self.gather(x[:self.b_l]),
                          self.gather(x[self.b_l:])], dim=0)

    def rows_l(self):
        return slice(self.rank * self.b_l, (self.rank + 1) * self.b_l)

    def rows_u(self):
        return slice(self.rank * self.b_u, (self.rank + 1) * self.b_u)

    def take_lu(self, x):
        """This rank's rows of a tensor over the global [labeled,
        unlabeled] rows."""
        n_l = self.world * self.b_l
        return torch.cat([x[self.rows_l()],
                          x[n_l:][self.rows_u()]], dim=0)

    def take_rows(self, flat, idx, per_sample: int):
        """``flat`` [(b_l + b_u) * per_sample, C], this rank's rows of the
        raster flatten; ``idx`` [...] int, flat indices into the global
        batch's. Returns flat_global[idx] [..., C] on every rank (in
        ``flat``'s dtype, exact, differentiable): each rank reads the rows
        it owns, the others stay 0, and one all-reduce in f32 sums them."""
        s, p = idx // per_sample, idx % per_sample
        n_l = self.world * self.b_l
        u = (s - n_l).clamp(min=0)
        owner = torch.where(s < n_l, s // self.b_l, u // self.b_u)
        row = torch.where(s < n_l, s % self.b_l, self.b_l + u % self.b_u)
        mine = owner == self.rank
        vals = flat[torch.where(mine, row * per_sample + p, 0)].float()
        vals = torch.where(mine[..., None], vals, 0.0)
        return self.sum(vals).to(flat.dtype)
