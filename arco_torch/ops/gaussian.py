"""Gaussian smoothing as separable 'same' zero-padded convolutions
(counterpart of arco_tpu/ops/gaussian.py), on NCHW tensors.

Each 1-D pass is a sum of shifted, zero-padded slices in f32: the taps
(7 for AdvMorph, 9 for the photometric blur) are few, and the sum stays
exact f32 whatever the TF32 flags of cuDNN say (the JAX convolution runs at
``Precision.HIGHEST``). The runtime-sigma blur takes one sigma per sample,
as a [B, taps] weight tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, kernel_size: int,
                       device="cpu") -> torch.Tensor:
    """Static-sigma normalized 1-D kernel."""
    x = torch.arange(kernel_size, dtype=torch.float32, device=device) \
        - (kernel_size - 1) / 2.0
    k = torch.exp(-(x * x) / (2.0 * sigma ** 2))
    return k / k.sum()


def adv_morph_kernel_size(kernel_size: int, sigma: float) -> int:
    """Reference size rule (adv_morph.py:460-462)."""
    if kernel_size < 2 * int(3.5 * sigma) + 1:
        return 2 * int(3.5 * sigma) + 1
    return kernel_size


def _conv_axis(x: torch.Tensor, kernel: torch.Tensor, dim: int):
    """'same' zero-padded correlation of an NCHW tensor along ``dim`` (2 or
    3) with ``kernel`` [taps] or, per sample, [B, taps]."""
    taps = kernel.shape[-1]
    pad = taps // 2
    n = x.shape[dim]
    xf = x.float()
    padded = F.pad(xf, (pad, pad, 0, 0) if dim == 3 else (0, 0, pad, pad))
    w = kernel.float().reshape(-1, taps, 1, 1, 1)    # [1 or B, taps, 1, 1, 1]
    out = torch.zeros_like(xf)
    for t in range(taps):
        out = out + w[:, t] * padded.narrow(dim, t, n)
    return out.to(x.dtype)


def gaussian_blur_2d(x: torch.Tensor, sigma: float,
                     kernel_size: int) -> torch.Tensor:
    """Blur [B, C, H, W] over H, then W, with a static sigma (the
    reference's renormalized 2-D product kernel is the same separable
    pair)."""
    k = gaussian_kernel_1d(sigma, kernel_size, x.device)
    return _conv_axis(_conv_axis(x, k, 2), k, 3)


def gaussian_blur_runtime_sigma(x: torch.Tensor, sigma,
                                radius: int = 4) -> torch.Tensor:
    """Blur [B, C, H, W] with one sigma per sample (``sigma`` [B] or a
    scalar), over a fixed radius: the photometric blur's sigma ~ U[0.15,
    1.15], so radius 4 covers 3.5 * sigma_max."""
    pos = torch.arange(2 * radius + 1, dtype=torch.float32,
                       device=x.device) - radius
    s = torch.as_tensor(sigma, dtype=torch.float32,
                        device=x.device).reshape(-1, 1)
    k = torch.exp(-(pos * pos) / (2.0 * s ** 2))
    k = k / k.sum(-1, keepdim=True)
    return _conv_axis(_conv_axis(x, k, 2), k, 3)
