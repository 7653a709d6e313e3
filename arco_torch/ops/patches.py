"""Loop-free patch grids over channels-last maps, 2D and 3D (counterpart of
arco_tpu/ops/patches.py).

The reference slides a half-overlap window over the logits with nested
Python loops (model_2D.py:265-268; ~700 windows in 3D, model_3D.py:355-359)
and runs the heads on each patch. Here the grid is one strided view
(``extract_patches_2d`` / ``extract_patches_3d``), and the pooled grid the
ISD heads read is computed from per-axis prefix sums without extracting
the patches (``pooled_patch_grid``). Inputs are channels-last [N, *spatial,
C] as in JAX; pass a model's [B, C, *spatial] logits as ``x.movedim(1,
-1)`` (a view). The patch order is the reference's row-major order over
the grid (in 3D: d-major, then h, then w).
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


def extract_patches_3d(x: torch.Tensor, patch: int, step: int):
    """[N, D, H, W, C] -> [N, P, patch, patch, patch, C], in the triple-loop
    order of model_3D.py:355-359 (d-major, then h, then w)."""
    n, c = x.shape[0], x.shape[-1]
    # [N, Pd, Ph, Pw, C, patch(d), patch(h), patch(w)], a view
    out = x.unfold(1, patch, step).unfold(2, patch, step) \
        .unfold(3, patch, step)
    return out.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(
        n, -1, patch, patch, patch, c)


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
    """adaptive_avg_pool(extract_patches_{2,3}d(x), out_size) without
    extracting the patches: [N, *spatial, C] -> [N, P, out, ..., out, C]
    for 2 or 3 spatial dims. Every pooled cell is a box mean, so per-axis
    prefix sums and boundary gathers give it directly (last spatial axis
    first, so the earlier axes keep their positions, as JAX does; each
    pass cast back to x's dtype)."""
    nd = x.ndim - 2
    n, c = x.shape[0], x.shape[-1]
    for axis in range(nd, 0, -1):
        x = _axis_window_means(x, axis, x.shape[axis], patch, step,
                               out_size)
    # [N, P1, out, P2, out, (P3, out,) C] -> [N, P1, P2, (P3,) out, ..., C]
    perm = (0,) + tuple(range(1, 2 * nd, 2)) + tuple(range(2, 2 * nd + 1, 2))
    x = x.permute(*perm, 2 * nd + 1)
    return x.reshape((n, -1) + (out_size,) * nd + (c,))
