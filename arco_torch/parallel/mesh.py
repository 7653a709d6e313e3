"""Process mesh and data-parallel helpers over torch.distributed
(counterpart of arco_tpu/parallel/mesh.py).

JAX jits the whole step once with NamedSharding constraints: the batch is
sharded over the 'data' mesh axis, parameters are replicated, and XLA
inserts the collectives. Here a mesh is a ``DeviceMesh`` over the
initialised process group, one rank a device (NCCL on the card, gloo for
CPU ranks). A rank holds its own slice of the batch (``shard_batch``), and
the code that needs a quantity of the whole batch reduces it itself:
models/layers.py's ``sync_batch_norm`` takes the BatchNorm statistics
over every rank's samples, ops/collectives.py's ``all_reduce_sum`` sums a
loss's partial sums (differentiably), and ``average_gradients`` here
averages the gradients.

JAX's ``batch_sharding`` and ``replicate_sharding`` have no counterpart: a
torch tensor carries no sharding. A rank's shard is a tensor of its own
(``shard_batch``), and a replicated module is one whose parameters and
buffers every rank holds equal (``replicate``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("data",),
                device_type: Optional[str] = None):
    """A DeviceMesh of ``shape`` over the initialised process group's
    ranks (-1 takes the ranks left over, as in JAX), on ``device_type``:
    by default "cuda" under NCCL and "cpu" otherwise; "cuda" under gloo
    puts gloo ranks on the cards' tensors."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if shape is None or tuple(shape) == (-1,):
        shape = (n,)
    known = math.prod(int(s) for s in shape if s != -1) or 1
    shape = tuple(int(s) if s != -1 else n // known for s in shape)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_rank(mesh, axis="data"):
    """(this rank's index along ``axis``, the axis's size, its group).
    ``axis`` may also be a tuple of every axis of ``mesh``, in order: the
    batch sharded over the whole mesh, row-major, as JAX's
    ``P(("data", "space"))`` shards it; such a mesh must span every rank
    of the process group."""
    if isinstance(axis, str):
        group = mesh.get_group(axis)
    elif tuple(axis) != tuple(mesh.mesh_dim_names):
        raise ValueError(f"axes {tuple(axis)} are not the mesh's "
                         f"{tuple(mesh.mesh_dim_names)}")
    elif len(axis) == 1:
        group = mesh.get_group(axis[0])
    elif mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("a batch over several mesh axes needs a mesh over "
                         "every rank, in rank order")
    else:
        group = dist.group.WORLD
    return dist.get_rank(group), dist.get_world_size(group), group


def shard_batch(batch, mesh, axis="data"):
    """This rank's contiguous slice of every [B, ...] tensor (or array) of
    a dict, list or tuple, on this rank's device: what JAX's
    ``NamedSharding(P(axis))`` places on each device (``axis`` as in
    ``axis_rank``)."""
    idx, n, _ = axis_rank(mesh, axis)
    device = mesh_device(mesh)

    def cut(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"batch axis ({x.shape[0]}) must divide evenly "
                             f"over mesh axis '{axis}' ({n} shards)")
        local = x.shape[0] // n
        return x.narrow(0, idx * local, local).to(device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return cut(tree)
    return walk(batch)


def replicate(module: torch.nn.Module, mesh, axis="data"):
    """Broadcast ``module``'s parameters and buffers from the axis's first
    rank, in place; returns the module."""
    _, _, group = axis_rank(mesh, axis)
    src = dist.get_process_group_ranks(group)[0]
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


def average_gradients(module: torch.nn.Module, group):
    """Replace each parameter's gradient by its mean over the group's ranks
    (one all-reduce of the flattened gradients)."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
