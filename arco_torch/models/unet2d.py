"""2D U-Net, ARCO's main 2D backbone (counterpart of
arco_tpu/models/unet2d.py:UNet), NCHW.

Forward contract: ``(logits, bottleneck_latent, feature_maps)`` with the
five decoder maps coarse -> fine, channels [256, 128, 64, 32, 16].
Module names follow networks/unetWithArgs.py (encoder.in_conv,
encoder.down{k}.maxpool_conv.1, decoder.up{k}.{conv1x1,conv},
decoder.out_conv).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from arco_torch.models.layers import BilinearUp, ConvBlock2D, max_pool


class _Down(nn.Module):
    def __init__(self, in_ch, out_ch, p):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          ConvBlock2D(in_ch, out_ch, p))

    def forward(self, x, mask=None, generator=None):
        return self.maxpool_conv[1](max_pool(x), mask, generator)


class Encoder(nn.Module):
    def __init__(self, in_chns, ft_chns, dropout):
        super().__init__()
        self.in_conv = ConvBlock2D(in_chns, ft_chns[0], dropout[0])
        for k in range(1, len(ft_chns)):
            setattr(self, f"down{k}",
                    _Down(ft_chns[k - 1], ft_chns[k], dropout[k]))
        self.depth = len(ft_chns)

    def forward(self, x, masks=None, generator=None):
        masks = masks or [None] * self.depth
        feats = [self.in_conv(x, masks[0], generator)]
        for k in range(1, self.depth):
            feats.append(getattr(self, f"down{k}")(feats[-1], masks[k],
                                                   generator))
        return feats


class _Up(BilinearUp):
    """BilinearUp, then the skip concat and a ConvBlock2D (UpBlock)."""

    def __init__(self, in_ch, skip_ch, out_ch):
        super().__init__(in_ch, out_ch)
        self.conv = ConvBlock2D(skip_ch + out_ch, out_ch, 0.0)

    def forward(self, x, skip):
        return self.conv(torch.cat([skip, super().forward(x)], dim=1))


class Decoder(nn.Module):
    def __init__(self, ft_chns, n_class):
        super().__init__()
        rev = list(ft_chns)[::-1]            # 256, 128, 64, 32, 16
        for k in range(1, len(rev)):
            setattr(self, f"up{k}", _Up(rev[k - 1], rev[k], rev[k]))
        self.out_conv = nn.Conv2d(rev[-1], n_class, 3, padding=1)
        self.depth = len(rev)

    def forward(self, feats):
        x = feats[-1]
        feature_map = [x]
        for k in range(1, self.depth):
            x = getattr(self, f"up{k}")(x, feats[-1 - k])
            feature_map.append(x)
        return self.out_conv(x), feature_map


class UNet(nn.Module):
    def __init__(self, in_chns: int = 1, class_num: int = 4,
                 ft_chns: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5)):
        super().__init__()
        self.class_num = class_num
        self.encoder = Encoder(in_chns, ft_chns, dropout)
        self.decoder = Decoder(ft_chns, class_num)

    def draw_dropout_masks(self, x_shape, generator=None, device=None):
        """The keep-masks that a train-mode forward of an input of
        ``x_shape`` draws from ``generator``, drawn in the same order (None
        for a block without dropout): a forward given them draws nothing."""
        enc = self.encoder
        blocks = [enc.in_conv] + [getattr(enc, f"down{k}").maxpool_conv[1]
                                  for k in range(1, enc.depth)]
        b, _, h, w = x_shape
        masks = []
        for k, block in enumerate(blocks):
            if k:
                h, w = h // 2, w // 2
            p = block.dropout_p
            shape = (b, block.conv_conv[0].out_channels, h, w)
            masks.append(torch.rand(shape, generator=generator, device=device)
                         < (1.0 - p) if self.training and p > 0.0 else None)
        return masks

    def forward(self, x, dropout_masks=None, generator=None):
        """``dropout_masks``: optional list of one keep-mask per encoder
        block (None entries draw from ``generator``)."""
        feats = self.encoder(x, dropout_masks, generator)
        logits, feature_map = self.decoder(feats)
        return logits, feats[-1], feature_map
