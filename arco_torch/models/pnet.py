"""PNet2D, the dilated-convolution pyramid network of DeepIGeoS
(counterpart of arco_tpu/models/pnet.py; reference networks/pnet.py:87-122),
NCHW.

Five PNetBlocks (two dilated 3x3 "SAME" convs, BatchNorm, LeakyReLU; the
dilations ``ratios``), the concat of all five, a two-conv 1x1 fuse
(``catblock``) and a 1x1 head with dropout 0.3 before each conv (``out``).
Module names are the reference's (block{k}.conv1/in1/conv2/in2 — ``in*``
are BatchNorms). Returns (logits, last block map, the five block maps).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from arco_torch.models.layers import BatchNorm2d, DropoutDraws, leaky_relu


class PNetBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, dilation: int):
        super().__init__()
        # a dilated 3x3 "SAME" conv pads the dilation on each side
        conv = lambda c: nn.Conv2d(c, features, 3, padding=dilation,
                                   dilation=dilation)
        self.conv1, self.in1 = conv(in_ch), BatchNorm2d(features)
        self.conv2, self.in2 = conv(features), BatchNorm2d(features)

    def forward(self, x):
        x = leaky_relu(self.in1(self.conv1(x)))
        return leaky_relu(self.in2(self.conv2(x)))


class _Conv1x1Pair(nn.Module):
    def __init__(self, in_ch, mid, out):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, mid, 1)
        self.conv2 = nn.Conv2d(mid, out, 1)


class PNet2D(nn.Module):
    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 num_filters: int = 64,
                 ratios: Sequence[int] = (1, 2, 4, 8, 16)):
        super().__init__()
        self.num_classes = num_classes
        self.latent_channels = num_filters
        chans = [in_chns] + [num_filters] * len(ratios)
        for k, r in enumerate(ratios):
            setattr(self, f"block{k + 1}",
                    PNetBlock(chans[k], num_filters, r))
        self.depth = len(ratios)
        cat = num_filters * len(ratios)
        self.catblock = _Conv1x1Pair(cat, cat, num_filters * 2)
        self.out = _Conv1x1Pair(num_filters * 2, num_filters, num_classes)

    def forward(self, x, dropout_masks=None, generator=None):
        """``dropout_masks``: the keep-masks of the two head dropouts."""
        draws = DropoutDraws(dropout_masks, generator, self.training)
        feats = []
        h = x
        for k in range(1, self.depth + 1):
            h = getattr(self, f"block{k}")(h)
            feats.append(h)
        conx = leaky_relu(self.catblock.conv1(torch.cat(feats, dim=1)))
        conx = leaky_relu(self.catblock.conv2(conx))
        h = leaky_relu(self.out.conv1(draws.dropout(conx, 0.3)))
        logits = self.out.conv2(draws.dropout(h, 0.3))
        return logits, feats[-1], feats
