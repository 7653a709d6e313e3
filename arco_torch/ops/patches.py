"""Loop-free patch grids over channels-last maps, 2D (counterpart of
arco_tpu/ops/patches.py, its 2D part).

The reference slides a half-overlap window over the logits with a nested
Python loop (model_2D.py:265-268) and runs the heads on each patch. Here the
grid is one strided view (``extract_patches_2d``), and the pooled grid the
ISD heads read is computed from per-axis prefix sums without extracting
the patches (``pooled_patch_grid``). Inputs are [N, H, W, C] as in JAX;
pass a model's NCHW logits as ``x.permute(0, 2, 3, 1)`` (a view). The
patch order is the reference's row-major order over the grid.
"""

from __future__ import annotations

import torch


def patch_grid_positions(size: int, patch: int, step: int):
    """Start offsets of the reference's ``range(0, size-patch+1, step)``."""
    return list(range(0, size - patch + 1, step))


def extract_patches_2d(x: torch.Tensor, patch: int, step: int):
    """[N, H, W, C] -> [N, P, patch, patch, C], row-major over the grid."""
    n, _, _, c = x.shape
    # [N, Py, Px, C, patch(y), patch(x)], a view
    out = x.unfold(1, patch, step).unfold(2, patch, step)
    return out.permute(0, 1, 2, 4, 5, 3).reshape(n, -1, patch, patch, c)


def _pool_bounds(patch: int, out: int, device=None):
    """torch AdaptiveAvgPool window bounds within one patch (they overlap
    for sizes that do not divide): [floor(i*p/o), ceil((i+1)*p/o)), as two
    int64 tensors made on ``device``, so nothing crosses from the host."""
    i = torch.arange(out, device=device)
    return i * patch // out, ((i + 1) * patch + out - 1) // out


def _axis_window_means(x: torch.Tensor, axis: int, size: int, patch: int,
                       step: int, out: int):
    """Replace ``axis`` with two axes [P, out] holding the mean of x over
    [start + s_i, start + e_i), from an exclusive prefix sum in f32 (bf16
    prefix differences cancel), cast back to x's dtype."""
    prefix = torch.cumsum(x.float(), dim=axis)
    zero = torch.zeros_like(prefix.narrow(axis, 0, 1))
    prefix = torch.cat([zero, prefix], dim=axis)
    starts = torch.arange(0, size - patch + 1, step, device=x.device)
    s, e = _pool_bounds(patch, out, x.device)
    lo = (starts[:, None] + s[None, :]).reshape(-1)
    hi = (starts[:, None] + e[None, :]).reshape(-1)
    seg = prefix.index_select(axis, hi) - prefix.index_select(axis, lo)
    seg = seg.reshape(x.shape[:axis] + (starts.numel(), out)
                      + x.shape[axis + 1:])
    lens = (e - s).float().reshape((out,) + (1,) * (x.ndim - axis - 1))
    return (seg / lens).to(x.dtype)


def pooled_patch_grid(x: torch.Tensor, patch: int, step: int,
                      out_size: int):
    """adaptive_avg_pool(extract_patches_2d(x), out_size) without extracting
    the patches: [N, H, W, C] -> [N, P, out, out, C]. Every pooled cell is
    a box mean, so two per-axis prefix sums and boundary gathers give it
    directly (last spatial axis first, as JAX does, each pass cast back to
    x's dtype)."""
    n, h, w, c = x.shape
    x = _axis_window_means(x, 2, w, patch, step, out_size)
    x = _axis_window_means(x, 1, h, patch, step, out_size)
    # [N, Py, out, Px, out, C] -> [N, Py, Px, out, out, C]
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, -1, out_size, out_size, c)
