"""Shared building blocks (counterpart of arco_tpu/models/layers.py), NCHW.

Module and parameter names follow the reference PyTorch U-Net
(networks/unetWithArgs.py): ``conv_conv.{0 conv, 1 bn, 4 conv, 5 bn}``, so
reference checkpoints load by name.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.ops.interpolate import resize_bilinear


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.01)


class _FlaxBatchNorm:
    """BatchNorm with flax's running-statistics rule, for any rank.

    flax ``BatchNorm(momentum=0.9)`` is torch ``momentum=0.1``, eps 1e-5.
    flax also updates the running variance with the BIASED batch variance,
    where torch's own BatchNorm uses the unbiased one (n/(n-1) larger: 8/7
    at the 2x2 bottleneck of a 32² batch of 2), so the running update is
    done here by hand, over every dim but the channels. Normalization
    itself uses the batch statistics, as both frameworks do in train
    mode."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        # off while a checkpointed forward is recomputed (running_stats_
        # frozen): the statistics move once per forward, as in JAX
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.update_stats:
            with torch.no_grad():
                dims = (0,) + tuple(range(2, x.ndim))
                var, mean = torch.var_mean(x.float(), dim=dims,
                                           correction=0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(
                    var, alpha=self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Train-mode forwards of ``module`` inside the block normalize with the
    batch statistics as usual but leave the running statistics alone."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def dropout(x, p: float, mask=None, generator=None, training: bool = True):
    """Inverted dropout with an explicit keep-``mask`` (bool, x's shape) or
    one drawn from ``generator``: x * keep / (1 - p), as flax Dropout."""
    if not training or p == 0.0:
        return x
    if mask is None:
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < (1.0 - p)
    return torch.where(mask, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


CONV = {2: nn.Conv2d, 3: nn.Conv3d}          # by spatial rank
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_BN = {2: BatchNorm2d, 3: BatchNorm3d}


class ConvBNAct(nn.Module):
    """Conv 3^nd (same) -> BatchNorm -> LeakyReLU(0.01) or ReLU, over
    ``nd`` spatial dims."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, nd: int = 2,
                 act: str = "leaky_relu"):
        super().__init__()
        if act not in ("leaky_relu", "relu"):
            raise ValueError(act)
        self.conv = CONV[nd](in_ch, out_ch, kernel, padding=kernel // 2)
        self.bn = _BN[nd](out_ch)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return leaky_relu(x) if self.act == "leaky_relu" else F.relu(x)


def ConvTransposeUp(in_ch: int, out_ch: int, nd: int = 3):
    """Transposed conv, kernel 2 and stride 2, over ``nd`` spatial dims
    (counterpart of arco_tpu/models/layers.py:ConvTransposeUp; torch's
    weight is flax's kernel flipped, see compat/from_flax.py)."""
    return _CONV_T[nd](in_ch, out_ch, 2, stride=2)


class ConvBlock2D(nn.Module):
    """Two (Conv3x3 + BN + LeakyReLU) with dropout after the first
    activation (unetWithArgs.py:31-47)."""

    def __init__(self, in_ch: int, out_ch: int, dropout_p: float):
        super().__init__()
        self.dropout_p = float(dropout_p)
        self.conv_conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1), BatchNorm2d(out_ch),
            nn.LeakyReLU(0.01), nn.Dropout(self.dropout_p),
            nn.Conv2d(out_ch, out_ch, 3, padding=1), BatchNorm2d(out_ch),
            nn.LeakyReLU(0.01))

    def forward(self, x, mask=None, generator=None):
        c = self.conv_conv
        x = leaky_relu(c[1](c[0](x)))
        x = dropout(x, self.dropout_p, mask, generator, self.training)
        return leaky_relu(c[5](c[4](x)))


def max_pool(x, window: int = 2):
    return F.max_pool2d(x, window, window)


class BilinearUp(nn.Module):
    """1x1 conv + 2x bilinear upsample (align_corners=True): the path the
    reference UpBlock actually takes (see arco_tpu/models/layers.py)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        x = self.conv1x1(x)
        return resize_bilinear(x, tuple(2 * s for s in x.shape[2:]),
                               align_corners=True)


def adaptive_avg_pool(x, out_size: int):
    """torch AdaptiveAvgPool over the spatial dims of NCHW ``x`` (counterpart
    of arco_tpu/models/layers.py:adaptive_avg_pool, which is channels-last):
    output cell i averages input rows floor(i*n/o) .. ceil((i+1)*n/o), so
    sizes that do not divide are covered too."""
    return F.adaptive_avg_pool2d(x, out_size)
