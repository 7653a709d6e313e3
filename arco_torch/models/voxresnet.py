"""VoxResNet, a 3D residual network with instance-norm pre-activation
(counterpart of arco_tpu/models/voxresnet.py), on [B, C, X, Y, Z] tensors.

networks/VoxResNet.py:79-116: a stem conv and max pool, six VoxRex residual
blocks with two more max pools, two UpBlocks (trilinear resize with
``align_corners=True`` to the skip's size, concat [skip, up], pre-activation
double conv), a final 2x trilinear upsample and a 1x1x1 head. Every norm is
a non-affine InstanceNorm (eps 1e-5), so the model holds no buffers.

Forward contract: ``(logits, x6, [x6, up1, up2])``. Module names follow the
reference as arco_tpu/compat/torch_import_zoo.py:convert_voxresnet_state_dict
reads them: ``conv1``, ``res{1..6}.block.{2,5}``,
``up{1,2}.conv.conv_conv.{2,5}``, ``out``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import InstanceNorm
from arco_torch.ops.interpolate import resize_bilinear


def _preact_double_conv(in_ch: int, out_ch: int):
    """IN, ReLU, conv 3^3 (no bias), IN, ReLU, conv 3^3: the convs at .2
    and .5."""
    return nn.Sequential(
        InstanceNorm(), nn.ReLU(),
        nn.Conv3d(in_ch, out_ch, 3, padding=1, bias=False),
        InstanceNorm(), nn.ReLU(),
        nn.Conv3d(out_ch, out_ch, 3, padding=1, bias=False))


class VoxRex(nn.Module):
    """Pre-activation residual block (VoxResNet.py:26-41)."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = _preact_double_conv(channels, channels)

    def forward(self, x):
        return self.block(x) + x


class _ConvConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_conv = _preact_double_conv(in_ch, out_ch)

    def forward(self, x):
        return self.conv_conv(x)


class UpBlock(nn.Module):
    """Trilinear resize of ``x1`` to ``x2``'s size (align_corners=True),
    concat [x2, x1], pre-activation double conv (VoxResNet.py:44-77)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = _ConvConv(in_ch, out_ch)

    def forward(self, x1, x2):
        x1 = resize_bilinear(x1, x2.shape[2:], align_corners=True)
        return self.conv(torch.cat([x2, x1], dim=1))


class VoxResNet(nn.Module):
    spatial_dims = 3

    def __init__(self, in_chns: int = 1, feature_chns: int = 64,
                 class_num: int = 2):
        super().__init__()
        f = feature_chns
        self.conv1 = nn.Conv3d(in_chns, f, 3, padding=1)
        for i in range(6):
            setattr(self, f"res{i + 1}", VoxRex(f))
        self.up1 = UpBlock(2 * f, f)
        self.up2 = UpBlock(2 * f, f)
        self.out = nn.Conv3d(f, class_num, 1)
        self.latent_channels = f

    def forward(self, x, dropout_masks=None, generator=None):
        """VoxResNet draws no dropout; the arguments keep the 3D models'
        call signature."""
        x = F.max_pool3d(self.conv1(x), 2, 2)
        x2 = self.res2(self.res1(x))
        x2_pool = F.max_pool3d(x2, 2, 2)
        x3 = self.res3(x2_pool)
        x4 = F.max_pool3d(self.res4(x3), 2, 2)
        x6 = self.res6(self.res5(x4))
        up1 = self.up1(x6, x2_pool)
        up2 = self.up2(up1, x)
        up = resize_bilinear(up2, tuple(2 * s for s in up2.shape[2:]),
                             align_corners=True)
        return self.out(up), x6, [x6, up1, up2]
