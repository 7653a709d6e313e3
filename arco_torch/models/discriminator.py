"""The segmentation-map discriminators of networks/discriminator.py:6-100
(counterpart of arco_tpu/models/discriminator.py), NCHW / NCDHW: dual-stem
strided-conv classifiers of adversarial semi-supervised variants.

- ``FC3DDiscriminator``: 4^3 stride-2 pad-1 convs of the segmentation map
  (``conv0``) and the image (``conv1``) summed, three more (``conv2..4``,
  ndf * 2 / 4 / 8), LeakyReLU(0.2) and dropout 0.5 after the first three,
  a global mean and ``classifier`` Linear(ndf * 8, 2).
- ``FCDiscriminator``: the same in 2D on the map and a feature map, with no
  activation after the sum and dropout after conv2 and conv3; then, as
  JAX's, a 7x7 average pool when the map's height is at least 7 and
  divisible by 7 (the reference's AvgPool2d(7) at 224), else a global
  mean, and ``classifier`` over the flattened map. The flatten is torch's
  (c, h, w), as the reference's, so the Linear's input width depends on
  the input size (``img_size``); compat/from_flax.py permutes flax's
  (h, w, c) Dense kernel to it.

Dropout masks can be passed in (``dropout_masks``, in call order), else
they are drawn from ``generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import DropoutDraws


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _convs(conv, num_classes: int, n_channel: int, ndf: int):
    return {"conv0": conv(num_classes, ndf, 4, stride=2, padding=1),
            "conv1": conv(n_channel, ndf, 4, stride=2, padding=1),
            "conv2": conv(ndf, ndf * 2, 4, stride=2, padding=1),
            "conv3": conv(ndf * 2, ndf * 4, 4, stride=2, padding=1),
            "conv4": conv(ndf * 4, ndf * 8, 4, stride=2, padding=1)}


class FC3DDiscriminator(nn.Module):
    def __init__(self, num_classes: int, ndf: int = 64, n_channel: int = 1):
        super().__init__()
        for name, conv in _convs(nn.Conv3d, num_classes, n_channel,
                                 ndf).items():
            setattr(self, name, conv)
        self.classifier = nn.Linear(ndf * 8, 2)

    def forward(self, seg_map, image, dropout_masks=None, generator=None):
        d = DropoutDraws(dropout_masks, generator, self.training)
        x = d.dropout(_lrelu(self.conv0(seg_map) + self.conv1(image)), 0.5)
        x = d.dropout(_lrelu(self.conv2(x)), 0.5)
        x = d.dropout(_lrelu(self.conv3(x)), 0.5)
        x = _lrelu(self.conv4(x))
        return self.classifier(x.mean(dim=(2, 3, 4)))


def _pooled_size(img_size):
    """The (h, w) of FCDiscriminator's pooled map for an input of
    ``img_size``: four stride-2 convs halve (floor) each side, then the
    7x7 average pool or the global mean."""
    h, w = (img_size, img_size) if isinstance(img_size, int) \
        else tuple(img_size)
    for _ in range(4):
        h, w = h // 2, w // 2
    return (h // 7, w // 7) if h >= 7 and h % 7 == 0 else (1, 1)


class FCDiscriminator(nn.Module):
    def __init__(self, num_classes: int, ndf: int = 64, n_channel: int = 1,
                 img_size=224):
        super().__init__()
        for name, conv in _convs(nn.Conv2d, num_classes, n_channel,
                                 ndf).items():
            setattr(self, name, conv)
        ph, pw = _pooled_size(img_size)
        self.classifier = nn.Linear(ndf * 8 * ph * pw, 2)

    def forward(self, seg_map, feature, dropout_masks=None, generator=None):
        d = DropoutDraws(dropout_masks, generator, self.training)
        x = self.conv0(seg_map) + self.conv1(feature)
        x = d.dropout(_lrelu(self.conv2(x)), 0.5)
        x = d.dropout(_lrelu(self.conv3(x)), 0.5)
        x = _lrelu(self.conv4(x))
        x = F.avg_pool2d(x, 7, 7) if x.shape[2] >= 7 and x.shape[2] % 7 == 0 \
            else x.mean(dim=(2, 3), keepdim=True)
        return self.classifier(torch.flatten(x, 1))
