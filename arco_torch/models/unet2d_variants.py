"""The STEGO and HAR 2D U-Net variants (counterpart of
arco_tpu/models/unet2d_variants.py), NCHW.

- UNetSTEGO (unetWithArgsSTEGO.py:140-166,316-360): the U-Net whose head
  adds a nonlinear cluster projection (1x1 -> ReLU -> 1x1,
  ``decoder.nonLinearPro``) into the logits. Same forward contract and
  dropout masks as the U-Net, so the ARCO step takes it.
- UNetHAR (unetWithArgs_HAR.py:31-120,352-474): every conv block's
  BatchNorm also hands out its pre-affine normalized map; the forward
  returns (logits, latent, feature_maps, bn_outputs).

Module names follow the reference (arco_tpu/compat/torch_import_zoo.py
reads them): ``encoder.down{k}.convBlock``, ``{block}.bn{j}.{gamma, beta,
bn}`` for HAR.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from arco_torch.models.layers import (BatchNorm2d, BilinearUp, DropoutDraws,
                                      leaky_relu, max_pool)
from arco_torch.models.unet2d import DROPOUT, FT_CHNS, Decoder, UNet


class BatchNormMul(nn.Module):
    """BatchNorm without scale or bias, then its own ``gamma`` and
    ``beta``; returns (affine output, pre-affine output)
    (unetWithArgs_HAR.py:31-44)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm2d(num_features, affine=False)
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        bn_out = self.bn(x)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (bn_out * self.gamma.reshape(shape)
                + self.beta.reshape(shape)), bn_out


class ConvBlockHAR(nn.Module):
    """conv1 -> bn1 -> LeakyReLU -> dropout -> conv2 -> bn2 -> LeakyReLU,
    with the two pre-affine taps."""

    def __init__(self, in_ch: int, out_ch: int, dropout_p: float):
        super().__init__()
        self.dropout_p = float(dropout_p)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.bn1 = BatchNormMul(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.bn2 = BatchNormMul(out_ch)

    def forward(self, x, draws: DropoutDraws):
        x, bn_a = self.bn1(self.conv1(x))
        x = draws.dropout(leaky_relu(x), self.dropout_p)
        x, bn_b = self.bn2(self.conv2(x))
        return leaky_relu(x), [bn_a, bn_b]


class _DownHAR(nn.Module):
    def __init__(self, in_ch, out_ch, p):
        super().__init__()
        self.convBlock = ConvBlockHAR(in_ch, out_ch, p)

    def forward(self, x, draws):
        return self.convBlock(max_pool(x), draws)


class _EncoderHAR(nn.Module):
    def __init__(self, in_chns, ft_chns, dropout):
        super().__init__()
        self.in_conv = ConvBlockHAR(in_chns, ft_chns[0], dropout[0])
        for k in range(1, len(ft_chns)):
            setattr(self, f"down{k}",
                    _DownHAR(ft_chns[k - 1], ft_chns[k], dropout[k]))
        self.depth = len(ft_chns)


class _UpHAR(BilinearUp):
    def __init__(self, in_ch, skip_ch, out_ch):
        super().__init__(in_ch, out_ch)
        self.conv = ConvBlockHAR(skip_ch + out_ch, out_ch, 0.0)

    def forward(self, x, skip, draws):
        return self.conv(torch.cat([skip, super().forward(x)], dim=1), draws)


class _DecoderHAR(nn.Module):
    def __init__(self, ft_chns, n_class):
        super().__init__()
        rev = list(ft_chns)[::-1]
        for k in range(1, len(rev)):
            setattr(self, f"up{k}", _UpHAR(rev[k - 1], rev[k], rev[k]))
        self.out_conv = nn.Conv2d(rev[-1], n_class, 3, padding=1)
        self.depth = len(rev)


class UNetHAR(nn.Module):
    """The U-Net trunk threading the 18 pre-affine BatchNorm taps
    (unetWithArgs_HAR.py:352). ``dropout_masks``: the keep-masks of the
    encoder blocks in order (DropoutDraws)."""

    def __init__(self, in_chns: int = 1, class_num: int = 4,
                 ft_chns=FT_CHNS, dropout=DROPOUT):
        super().__init__()
        self.class_num = class_num
        self.encoder = _EncoderHAR(in_chns, ft_chns, dropout)
        self.decoder = _DecoderHAR(ft_chns, class_num)

    def forward(self, x, dropout_masks=None, generator=None):
        draws = DropoutDraws(dropout_masks, generator, self.training)
        enc, dec = self.encoder, self.decoder
        h, bn_outputs = enc.in_conv(x, draws)
        feats = [h]
        for k in range(1, enc.depth):
            h, bns = getattr(enc, f"down{k}")(h, draws)
            bn_outputs += bns
            feats.append(h)
        feature_map = [h]
        for k in range(1, dec.depth):
            h, bns = getattr(dec, f"up{k}")(h, feats[-1 - k], draws)
            bn_outputs += bns
            feature_map.append(h)
        return dec.out_conv(h), feats[-1], feature_map, bn_outputs


class _STEGODecoder(Decoder):
    """The U-Net decoder whose logits also take the cluster projection
    ``nonLinearPro`` (1x1 -> ReLU -> 1x1) of the last map."""

    def __init__(self, ft_chns, n_class):
        super().__init__(ft_chns, n_class)
        self.nonLinearPro = nn.Sequential(
            nn.Conv2d(ft_chns[0], ft_chns[0], 1), nn.ReLU(),
            nn.Conv2d(ft_chns[0], n_class, 1))

    def forward(self, feats):
        logits, feature_map = super().forward(feats)
        return logits + self.nonLinearPro(feature_map[-1]), feature_map


class UNetSTEGO(UNet):
    """unetWithArgsSTEGO.py:316: the U-Net with the cluster projection
    summed into its logits."""

    def __init__(self, in_chns: int = 1, class_num: int = 4):
        super().__init__(in_chns, class_num)
        self.decoder = _STEGODecoder(FT_CHNS, class_num)
