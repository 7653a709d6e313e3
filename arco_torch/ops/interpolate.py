"""Resize and grid-sample primitives (counterpart of
arco_tpu/ops/interpolate.py), on NCHW and NCDHW tensors.

The JAX versions are channels-last matmul/gather formulations that XLA
compiles; here the same functions are stock PyTorch operators, computed in
f32 and cast back to the input dtype as the JAX versions do."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_spatial,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of an NCHW batch to ``out_spatial`` (H, W), or
    trilinear of an NCDHW batch to (D, H, W), in f32."""
    if tuple(x.shape[2:]) == tuple(out_spatial):
        return x
    mode = {4: "bilinear", 5: "trilinear"}[x.ndim]
    y = F.interpolate(x.float(), size=tuple(out_spatial), mode=mode,
                      align_corners=align_corners)
    return y.to(x.dtype)


def resize_nearest(x: torch.Tensor, out_spatial, channels_last: bool = False):
    """Nearest resize with the JAX index rule idx = floor(i * in / out).

    ``x`` is [N, C, *S] or, with ``channels_last``, [N, *S, C]; integer
    and bool tensors keep their dtype."""
    first = 1 if channels_last else 2
    spatial = x.shape[first:first + len(out_spatial)]
    y = x
    for axis, (s_in, s_out) in enumerate(zip(spatial, out_spatial),
                                         start=first):
        if s_in == s_out:
            continue
        idx = torch.floor(torch.arange(s_out, dtype=torch.float32)
                          * (s_in / s_out)).long().clamp(0, s_in - 1)
        y = torch.index_select(y, axis, idx.to(x.device))
    return y


def grid_sample_2d(x: torch.Tensor, grid: torch.Tensor,
                   mode: str = "bilinear", padding_mode: str = "zeros",
                   align_corners: bool = True) -> torch.Tensor:
    """torch grid_sample on NCHW ``x`` with grid [N, Hg, Wg, 2] (x, y)."""
    y = F.grid_sample(x.float(), grid.float(), mode=mode,
                      padding_mode=padding_mode, align_corners=align_corners)
    return y.to(x.dtype)
