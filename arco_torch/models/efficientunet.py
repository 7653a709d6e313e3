"""EfficientUNet: an EfficientNet-B3 encoder under a U-Net decoder
(counterpart of arco_tpu/models/efficientunet.py; reference
networks/efficientunet.py:143-221, factory key 'efficient_unet'), NCHW.

B3 scaling: width x1.2, depth x1.4, a 40-channel stem; MBConv blocks with
SiLU (swish), squeeze-excite ratio 0.25 and BatchNorm; no ImageNet weights
(the encoder trains from scratch, as in JAX). Every strided conv pads as
flax's "SAME" does (layers.same_pad: (0, 1) for 3x3/s2, (1, 2) for 5x5/s2
on even sizes). Returns (logits, the stride-32 latent, six decoder maps).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import BatchNorm2d, SameConv2d
from arco_torch.ops.interpolate import resize_bilinear

# (expand_ratio, channels, repeats, stride, kernel): EfficientNet-B0
B0_BLOCKS = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]


def _round_filters(f: int, width: float) -> int:
    f *= width
    new_f = max(8, int(f + 4) // 8 * 8)
    if new_f < 0.9 * f:
        new_f += 8
    return int(new_f)


def _round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, reduced, 1)
        self.expand = nn.Conv2d(reduced, channels, 1)

    def forward(self, x):
        s = F.silu(self.reduce(x.mean(dim=(2, 3), keepdim=True)))
        s = torch.sigmoid(self.expand(s).float())
        return x * s.to(x.dtype)


class MBConv(nn.Module):
    """[1x1 expand, BN, swish] -> depthwise kxk/s ("SAME"), BN, swish ->
    squeeze-excite -> 1x1 project, BN (+ the input when the shape
    stays)."""

    def __init__(self, cin: int, cout: int, expand: int, stride: int,
                 kernel: int, se_ratio: float = 0.25):
        super().__init__()
        mid = cin * expand
        if expand != 1:
            self.expand_conv = nn.Conv2d(cin, mid, 1, bias=False)
            self.expand_bn = BatchNorm2d(mid)
        self.dw_conv = SameConv2d(mid, mid, kernel, stride=stride,
                                  groups=mid, bias=False)
        self.dw_bn = BatchNorm2d(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio)))
        self.project_conv = nn.Conv2d(mid, cout, 1, bias=False)
        self.project_bn = BatchNorm2d(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = x
        if hasattr(self, "expand_conv"):
            h = F.silu(self.expand_bn(self.expand_conv(h)))
        h = F.silu(self.dw_bn(self.dw_conv(h)))
        h = self.project_bn(self.project_conv(self.se(h)))
        return h + x if self.residual else h


class EfficientNetEncoder(nn.Module):
    """The five feature levels at strides 2/4/8/16/32."""

    def __init__(self, in_chns: int = 1, width: float = 1.2,
                 depth: float = 1.4):
        super().__init__()
        stem = _round_filters(32, width)
        self.stem_conv = SameConv2d(in_chns, stem, 3, stride=2, bias=False)
        self.stem_bn = BatchNorm2d(stem)
        blocks, self.taps, self.level_channels = [], [], []
        cin = stem
        for e, c, r, s, k in B0_BLOCKS:
            cout = _round_filters(c, width)
            for j in range(_round_repeats(r, depth)):
                stride = s if j == 0 else 1
                # a level's map is the input of the next strided block
                self.taps.append(stride == 2)
                if stride == 2:
                    self.level_channels.append(cin)
                blocks.append(MBConv(cin, cout, e, stride, k))
                cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.level_channels.append(cin)

    def forward(self, x):
        h = F.silu(self.stem_bn(self.stem_conv(x)))
        feats = []
        for tap, block in zip(self.taps, self.blocks):
            if tap:
                feats.append(h)
            h = block(h)
        feats.append(h)
        return feats


class _DecoderStage(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_ch)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class EffiUNet(nn.Module):
    """'efficient_unet': each decoder stage upsamples 2x (bilinear,
    align_corners=False), concats the encoder skip (none at full
    resolution) and runs two 3x3 conv + BN + ReLU."""

    def __init__(self, num_classes: int = 4, in_chns: int = 1,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.num_classes = num_classes
        self.encoder = EfficientNetEncoder(in_chns)
        levels = self.encoder.level_channels
        self.latent_channels = levels[-1]
        # the skips: the encoder maps at strides 16, 8, 4, 2, then none
        skips = levels[-2::-1] + [0]
        cin = self.latent_channels
        self.decoder = nn.ModuleList()
        for ch, skip in zip(decoder_channels, skips):
            self.decoder.append(_DecoderStage(cin + skip, ch))
            cin = ch
        self.out_conv = nn.Conv2d(cin, num_classes, 3, padding=1)

    def forward(self, x, dropout_masks=None, generator=None):
        """No dropout: ``dropout_masks`` and ``generator`` are ignored."""
        feats = self.encoder(x)
        h = latent = feats[-1]
        feature_map = [h]
        for stage, skip in zip(self.decoder, feats[-2::-1] + [None]):
            h = resize_bilinear(h, tuple(2 * s for s in h.shape[2:]),
                                align_corners=False)
            if skip is not None:
                h = torch.cat([h, skip], dim=1)
            h = stage(h)
            feature_map.append(h)
        return self.out_conv(h), latent, feature_map
