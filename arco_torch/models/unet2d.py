"""2D U-Net, ARCO's main 2D backbone (counterpart of
arco_tpu/models/unet2d.py:UNet), NCHW.

Forward contract: ``(logits, bottleneck_latent, feature_maps)`` with the
five decoder maps coarse -> fine, channels [256, 128, 64, 32, 16].
Module names follow networks/unetWithArgs.py (encoder.in_conv,
encoder.down{k}.maxpool_conv.1, decoder.up{k}.{conv1x1,conv},
decoder.out_conv).

The variants of the reference factory (unetWithArgs.py:351-417) return four
values: UNetDS (deep-supervision heads), UNetCCT (three aux decoders over
perturbed encoder features) and UNetURPC (multi-scale heads over
noise-perturbed decoder maps).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from arco_torch.models.layers import (BilinearUp, ConvBlock2D,
                                      FeaturePerturbation, max_pool)
from arco_torch.ops.interpolate import resize_bilinear

FT_CHNS = (16, 32, 64, 128, 256)
DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


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
                 ft_chns: Sequence[int] = FT_CHNS,
                 dropout: Sequence[float] = DROPOUT):
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


class _DeepHeads(nn.Module):
    """The 3x3 heads out_conv_dp3, dp2, dp1 over decoder maps 1..3,
    upsampled to the input size (align_corners=False)."""

    def __init__(self, class_num):
        super().__init__()
        for name, ch in zip(("dp3", "dp2", "dp1"), FT_CHNS[-2:0:-1]):
            setattr(self, f"out_conv_{name}",
                    nn.Conv2d(ch, class_num, 3, padding=1))

    def heads(self, fmap, size, noise=None):
        outs = []
        for name, f in zip(("dp3", "dp2", "dp1"), fmap[1:4]):
            if noise is not None:
                f = noise(f)
            head = getattr(self, f"out_conv_{name}")(f)
            outs.append(resize_bilinear(head, size, align_corners=False))
        return outs


class UNetDS(_DeepHeads):
    """Deep-supervision variant (unetWithArgs.py:400-417): returns
    (logits, dp3, dp2, dp1)."""

    def __init__(self, in_chns: int = 1, class_num: int = 4):
        super().__init__(class_num)
        self.class_num = class_num
        self.encoder = Encoder(in_chns, FT_CHNS, DROPOUT)
        self.decoder = Decoder(FT_CHNS, class_num)

    def forward(self, x, dropout_masks=None, generator=None):
        feats = self.encoder(x, dropout_masks, generator)
        logits, fmap = self.decoder(feats)
        return (logits, *self.heads(fmap, x.shape[2:]))


class UNetURPC(_DeepHeads):
    """Uncertainty-rectified pyramid-consistency variant
    (unetWithArgs.py:379-398): UNetDS whose heads see feature-noised maps
    in train mode. ``noise``: optional [dp3, dp2, dp1] uniforms in [-0.3,
    0.3) of the three maps' shapes (None entries drawn from
    ``generator``)."""

    def __init__(self, in_chns: int = 1, class_num: int = 4):
        super().__init__(class_num)
        self.class_num = class_num
        self.encoder = Encoder(in_chns, FT_CHNS, DROPOUT)
        self.decoder = Decoder(FT_CHNS, class_num)

    def forward(self, x, dropout_masks=None, generator=None, noise=None):
        feats = self.encoder(x, dropout_masks, generator)
        logits, fmap = self.decoder(feats)
        perturb = None
        if self.training:
            draws = iter(noise or [None] * 3)
            perturb = lambda f: FeaturePerturbation.feature_noise(
                f, noise=next(draws), generator=generator)
        return (logits, *self.heads(fmap, x.shape[2:], perturb))


class UNetCCT(nn.Module):
    """Cross-consistency-training variant (unetWithArgs.py:351-377): one
    encoder, a main decoder and three aux decoders over the encoder maps
    perturbed by feature noise, dropout and feature dropout, in train and
    in eval mode. Returns (main_logits, aux1, aux2, aux3).

    ``perturb``: optional draws [noise, keep, u], each a list over the five
    encoder maps (the noise uniforms and keep-masks of each map's shape,
    the feature-dropout factors [B]); None entries come from
    ``generator``. JAX draws the eval-mode ones from fixed keys; the tests
    hand those over."""

    def __init__(self, in_chns: int = 1, class_num: int = 4):
        super().__init__()
        self.class_num = class_num
        self.encoder = Encoder(in_chns, FT_CHNS, DROPOUT)
        self.main_decoder = Decoder(FT_CHNS, class_num)
        for k in range(1, 4):
            setattr(self, f"aux_decoder{k}", Decoder(FT_CHNS, class_num))

    def forward(self, x, dropout_masks=None, generator=None, perturb=None):
        feats = self.encoder(x, dropout_masks, generator)
        outs = [self.main_decoder(feats)[0]]
        fp = FeaturePerturbation
        fns = (lambda f, d: fp.feature_noise(f, noise=d, generator=generator),
               lambda f, d: fp.dropout(f, keep=d, generator=generator),
               lambda f, d: fp.feature_dropout(f, u=d, generator=generator))
        perturb = perturb or [None] * 3
        for k, fn in enumerate(fns):
            draws = perturb[k] or [None] * len(feats)
            pfeats = [fn(f, d) for f, d in zip(feats, draws)]
            outs.append(getattr(self, f"aux_decoder{k + 1}")(pfeats)[0])
        return tuple(outs)
