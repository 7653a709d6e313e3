"""Spatial-axis sharding with halo exchange for whole-volume 3D forwards
(counterpart of arco_tpu/parallel/spatial.py).

The reference handles large volumes only by patch-wise sliding-window
inference (test_util.py:139-211). Here one spatial axis of the volume is
split over the ranks of a mesh axis, and each rank exchanges fixed-width
halo slabs with its neighbours so that the convolutions' receptive fields
see across the shard boundaries.

- ``_halo_pass``: each rank sends its leading and trailing ``halo`` slabs
  to its neighbours and receives theirs, as one ``batch_isend_irecv`` of
  point-to-point ops, so no rank blocks on an unmatched send (gloo ranks
  on a card stage the slabs through the host). The global edges extend
  with zeros, so the first SAME conv sees what the unsharded
  forward sees there.
- ``sharded_volume_forward`` wraps a forward: cut this rank's slab, extend
  it by the halos, run the forward on [local + 2*halo], crop ``halo`` from
  the output and gather the ranks' output slabs into the whole output (JAX
  returns the global array).

Layout: the port's volumes are [B, C, D, H, W], so the axis JAX shards as
axis 1 of [B, D, H, W, C] is axis 2 here. ``spatial_axis`` counts over the
port's layout and defaults to 2.

Patch-wise sliding window stays the default evaluation
(eval/sliding_window*.py); this is the whole-volume-at-once path.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from arco_torch.parallel.mesh import axis_rank, mesh_device


def _halo_pass(x: torch.Tensor, group, halo: int, spatial_axis: int):
    """Exchange ``halo``-wide slabs with the neighbouring ranks of
    ``group`` along ``spatial_axis``.

    x: this rank's shard. Returns it extended to L_local + 2*halo. The
    global edges extend with ZEROS. Exactness contract (as in JAX): the
    sharded forward equals the unsharded one everywhere except within the
    receptive-field half-width of the GLOBAL volume edge, since stacked
    SAME convs re-pad with zeros at every layer; shard-boundary crossings
    are exact for halo >= RF/2."""
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    ranks = dist.get_process_group_ranks(group)
    size = x.shape[spatial_axis]
    lo_slab = x.narrow(spatial_axis, 0, halo).contiguous()
    hi_slab = x.narrow(spatial_axis, size - halo, halo).contiguous()
    # gloo sends no CUDA tensor: its ranks on a card trade through the host
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    if host:
        lo_slab, hi_slab = lo_slab.cpu(), hi_slab.cpu()
    left, right = torch.zeros_like(lo_slab), torch.zeros_like(hi_slab)
    ops = []
    if idx > 0:            # trade leading slabs with the left neighbour
        ops += [dist.P2POp(dist.isend, lo_slab, ranks[idx - 1], group),
                dist.P2POp(dist.irecv, left, ranks[idx - 1], group)]
    if idx < n - 1:        # and trailing slabs with the right one
        ops += [dist.P2POp(dist.isend, hi_slab, ranks[idx + 1], group),
                dist.P2POp(dist.irecv, right, ranks[idx + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if host:
        left, right = left.to(x.device), right.to(x.device)
    return torch.cat([left, x, right], dim=spatial_axis)


def _crop(x: torch.Tensor, halo: int, spatial_axis: int):
    return x.narrow(spatial_axis, halo, x.shape[spatial_axis] - 2 * halo)


def sharded_volume_forward(forward: Callable, mesh, *, halo: int,
                           spatial_axis: int = 2, mesh_axis: str = "data",
                           lattice: int = 1, out_ndim_same: bool = True):
    """Build f(volume) that runs ``forward`` over a whole volume whose
    ``spatial_axis`` is split across ``mesh_axis``. Every rank calls it
    with the whole volume (on any device); each moves only its own slab to
    its device, and every rank gets the whole output back.

    forward: local function mapping [B, C, D_loc+2h, H, W] -> an output of
      the same resolution (e.g. softmax scores).
    halo: receptive-field half-width to exchange; the sharded forward
      equals the unsharded one wherever the network's receptive field fits
      inside the exchanged slab.
    lattice: the model's downsampling stride product (16 for the 4-stage
      V-Net/U-Net). The extended local slab (D_local + 2*halo) must be a
      multiple of it or the decoder's skip connections misalign.
    """
    def call(volume):
        if halo < 1:
            # a zero-wide slab would exchange nothing; a halo-free forward
            # needs no exchange: call `forward` plain
            raise ValueError("halo must be >= 1 (for halo=0 run the "
                             "forward without sharded_volume_forward)")
        _, n_shards, group = axis_rank(mesh, mesh_axis)
        dim = volume.shape[spatial_axis]
        if dim % n_shards:
            raise ValueError(
                f"volume axis {spatial_axis} ({dim}) must divide evenly "
                f"over mesh axis '{mesh_axis}' ({n_shards} shards)")
        local = dim // n_shards
        if halo > local:
            raise ValueError(
                f"halo ({halo}) exceeds the local shard extent ({local}); "
                f"use fewer shards or a smaller halo")
        ext = local + 2 * halo
        if ext % lattice:
            raise ValueError(
                f"extended slab {local}+2*{halo}={ext} is not a multiple of "
                f"the model's stride lattice ({lattice}); pick halo so that "
                f"(D/shards + 2*halo) % {lattice} == 0")
        slab = shard_volume(volume, mesh, spatial_axis, mesh_axis)
        out = forward(_halo_pass(slab, group, halo, spatial_axis))
        if out_ndim_same:
            out = _crop(out, halo, spatial_axis)
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(n_shards)]
        dist.all_gather(parts, out, group=group)
        return torch.cat(parts, dim=spatial_axis)

    return call


def shard_volume(volume, mesh, spatial_axis: int = 2,
                 mesh_axis: str = "data") -> torch.Tensor:
    """This rank's contiguous slab of a [B, C, D, H, W] volume along
    ``spatial_axis``, on this rank's device."""
    idx, n, _ = axis_rank(mesh, mesh_axis)
    volume = torch.as_tensor(volume)
    dim = volume.shape[spatial_axis]
    if dim % n:
        raise ValueError(
            f"volume axis {spatial_axis} ({dim}) must divide evenly "
            f"over mesh axis '{mesh_axis}' ({n} shards)")
    local = dim // n
    return volume.narrow(spatial_axis, idx * local, local).to(
        mesh_device(mesh))
