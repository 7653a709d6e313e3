"""ENet, the real-time 2D segmentation network (counterpart of
arco_tpu/models/enet.py; reference networks/enet.py:453-614), NCHW.

An initial block, three encoder stages of bottlenecks (regular, dilated and
asymmetric 5x1 + 1x5 convs, PReLU), two decoder stages with max-unpooling
(ReLU), and a transposed-conv head at full resolution. Module names are
the reference's (arco_tpu/compat/torch_import_zoo.py reads them).

The 2x2 pooling hands its argmax to the unpooling as a one-hot over the
window's four slots, the first maximum in the order (0,0), (0,1), (1,0),
(1,1), as JAX does: ``F.max_pool2d(..., return_indices=True)`` leaves the
choice among ties to the backend, and ReLU maps tie often. The pooled
value is ``amax``, whose gradient splits among ties as JAX's max does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import BatchNorm2d, DropoutDraws


def max_pool_with_onehot(x):
    """2x2/2 max pool of NCHW ``x``: (pooled [N, C, H/2, W/2], one-hot of
    the first maximum [N, C, H/2, W/2, 4], in x's dtype)."""
    n, c, h, w = x.shape
    blocks = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    blocks = blocks.reshape(n, c, h // 2, w // 2, 4)
    pooled = blocks.amax(dim=-1)
    with torch.no_grad():
        hit = (blocks == pooled[..., None]).to(torch.int32)
        first = (hit.cumsum(dim=-1) == 1) & (hit == 1)
    return pooled, first.to(x.dtype)


def max_unpool(x, onehot):
    """Inverse of ``max_pool_with_onehot``: each value to its argmax slot,
    zeros elsewhere."""
    n, c, h2, w2 = x.shape
    blocks = (x[..., None] * onehot).reshape(n, c, h2, w2, 2, 2)
    return blocks.permute(0, 1, 2, 4, 3, 5).reshape(n, c, 2 * h2, 2 * w2)


def _act(relu: bool):
    """ReLU, or torch's nn.PReLU(): one shared slope initialized to 0.25,
    as JAX's PReLU and the reference's no-argument constructor."""
    return nn.ReLU() if relu else nn.PReLU()


def _cba(in_ch, out_ch, kernel, relu, stride=1, padding=0, dilation=1):
    """conv (no bias) -> BatchNorm -> activation: the reference's
    Sequential, indices 0, 1, 2."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                  dilation=dilation, bias=False),
        BatchNorm2d(out_ch), _act(relu))


class InitialBlock(nn.Module):
    """3x3/s2 conv (out - in channels, pad 1) concat 3x3/s2 max pool (pad
    1): enet.py:5-68."""

    def __init__(self, in_channels: int, out_channels: int = 16,
                 relu: bool = False):
        super().__init__()
        self.main_branch = nn.Conv2d(in_channels, out_channels - in_channels,
                                     3, stride=2, padding=1, bias=False)
        self.batch_norm = BatchNorm2d(out_channels)
        self.out_activation = _act(relu)

    def forward(self, x):
        ext = F.max_pool2d(x, 3, stride=2, padding=1)
        out = torch.cat([self.main_branch(x), ext], dim=1)
        return self.out_activation(self.batch_norm(out))


class RegularBottleneck(nn.Module):
    """1x1 reduce -> (3x3 dilated | 5x1 + 1x5) -> 1x1 expand, dropout,
    residual add (enet.py:71-207)."""

    def __init__(self, channels: int, internal_ratio: int = 4,
                 kernel_size: int = 3, dilation: int = 1,
                 asymmetric: bool = False, dropout_prob: float = 0.0,
                 relu: bool = False):
        super().__init__()
        internal = channels // internal_ratio
        k = kernel_size
        self.dropout_prob = dropout_prob
        self.ext_conv1 = _cba(channels, internal, 1, relu)
        if asymmetric:
            # BN + activation after each half (enet.py:151-167)
            self.ext_conv2 = nn.Sequential(
                *_cba(internal, internal, (k, 1), relu, padding=(k // 2, 0)),
                *_cba(internal, internal, (1, k), relu, padding=(0, k // 2)))
        else:
            pad = (k - 1) // 2 * dilation
            self.ext_conv2 = _cba(internal, internal, k, relu, padding=pad,
                                  dilation=dilation)
        self.ext_conv3 = _cba(internal, channels, 1, relu)
        self.out_activation = _act(relu)

    def forward(self, x, draws: DropoutDraws):
        h = self.ext_conv3(self.ext_conv2(self.ext_conv1(x)))
        return self.out_activation(x + draws.dropout(h, self.dropout_prob))


class DownsamplingBottleneck(nn.Module):
    """Main: 2x2 max pool, channels zero-padded; ext: 2x2/s2 conv, 3x3,
    1x1 (enet.py:209-338). Returns (out, the pool's one-hot)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_prob: float = 0.0, relu: bool = False):
        super().__init__()
        internal = in_channels // 4
        self.pad = out_channels - in_channels
        self.dropout_prob = dropout_prob
        self.ext_conv1 = _cba(in_channels, internal, 2, relu, stride=2)
        self.ext_conv2 = _cba(internal, internal, 3, relu, padding=1)
        self.ext_conv3 = _cba(internal, out_channels, 1, relu)
        self.out_activation = _act(relu)

    def forward(self, x, draws: DropoutDraws):
        main, onehot = max_pool_with_onehot(x)
        main = F.pad(main, (0, 0, 0, 0, 0, self.pad))
        h = self.ext_conv3(self.ext_conv2(self.ext_conv1(x)))
        h = draws.dropout(h, self.dropout_prob)
        return self.out_activation(main + h), onehot


class UpsamplingBottleneck(nn.Module):
    """Main: 1x1 conv + BN, max-unpooled; ext: 1x1, 2x2/s2 transposed
    conv, 1x1 (enet.py:340-451)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_prob: float = 0.0, relu: bool = True):
        super().__init__()
        internal = in_channels // 4
        self.dropout_prob = dropout_prob
        self.main_conv1 = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 1, bias=False),
            BatchNorm2d(out_channels))
        self.ext_conv1 = _cba(in_channels, internal, 1, relu)
        self.ext_tconv1 = nn.ConvTranspose2d(internal, internal, 2, stride=2,
                                             bias=False)
        self.ext_tconv1_bnorm = BatchNorm2d(internal)
        self.ext_tconv1_activation = _act(relu)
        self.ext_conv2 = _cba(internal, out_channels, 1, relu)
        self.out_activation = _act(relu)

    def forward(self, x, onehot, draws: DropoutDraws):
        main = max_unpool(self.main_conv1(x), onehot)
        h = self.ext_tconv1_activation(self.ext_tconv1_bnorm(
            self.ext_tconv1(self.ext_conv1(x))))
        h = draws.dropout(self.ext_conv2(h), self.dropout_prob)
        return self.out_activation(main + h)


# stage 2 and stage 3 (without its downsampling): (name, kernel, dilation,
# asymmetric), enet.py:507-555
_STAGE = (("regular{}_{}", 3, 1, False), ("dilated{}_{}", 3, 2, False),
          ("asymmetric{}_{}", 5, 1, True), ("dilated{}_{}", 3, 4, False),
          ("regular{}_{}", 3, 1, False), ("dilated{}_{}", 3, 8, False),
          ("asymmetric{}_{}", 5, 1, True), ("dilated{}_{}", 3, 16, False))


class ENet(nn.Module):
    """Returns (logits, latent = the stage-2 output, [latent, the 64- and
    16-channel decoder maps]). ``dropout_masks``: the keep-masks of the
    bottlenecks' dropouts in order (DropoutDraws)."""

    def __init__(self, in_channels: int = 1, num_classes: int = 2,
                 encoder_relu: bool = False, decoder_relu: bool = True):
        super().__init__()
        er, dr = encoder_relu, decoder_relu
        self.num_classes = num_classes
        self.latent_channels = 128
        self.initial_block = InitialBlock(in_channels, 16, er)
        self.downsample1_0 = DownsamplingBottleneck(16, 64, 0.01, er)
        for j in range(1, 5):
            setattr(self, f"regular1_{j}",
                    RegularBottleneck(64, dropout_prob=0.01, relu=er))
        self.downsample2_0 = DownsamplingBottleneck(64, 128, 0.1, er)
        self.stage23 = []
        for stage, first in ((2, 1), (3, 0)):
            for j, (name, k, d, asym) in enumerate(_STAGE):
                name = name.format(stage, first + j)
                setattr(self, name, RegularBottleneck(
                    128, kernel_size=k, dilation=d, asymmetric=asym,
                    dropout_prob=0.1, relu=er))
                self.stage23.append(name)
        self.upsample4_0 = UpsamplingBottleneck(128, 64, 0.1, dr)
        self.regular4_1 = RegularBottleneck(64, dropout_prob=0.1, relu=dr)
        self.regular4_2 = RegularBottleneck(64, dropout_prob=0.1, relu=dr)
        self.upsample5_0 = UpsamplingBottleneck(64, 16, 0.1, dr)
        self.regular5_1 = RegularBottleneck(16, dropout_prob=0.1, relu=dr)
        # k3/s2, padding 1 and output_padding 1: the dilated input padded
        # (1, 2), as JAX's ConvTranspose padding ((1, 2), (1, 2))
        self.transposed_conv = nn.ConvTranspose2d(
            16, num_classes, 3, stride=2, padding=1, output_padding=1,
            bias=False)

    def forward(self, x, dropout_masks=None, generator=None):
        d = DropoutDraws(dropout_masks, generator, self.training)
        h = self.initial_block(x)
        h, oh1 = self.downsample1_0(h, d)
        for j in range(1, 5):
            h = getattr(self, f"regular1_{j}")(h, d)
        h, oh2 = self.downsample2_0(h, d)
        for i, name in enumerate(self.stage23):
            h = getattr(self, name)(h, d)
            if i == len(_STAGE) - 1:
                latent = h
        h = self.upsample4_0(h, oh2, d)
        f64 = self.regular4_2(self.regular4_1(h, d), d)
        f16 = self.regular5_1(self.upsample5_0(f64, oh1, d), d)
        return self.transposed_conv(f16), latent, [latent, f64, f16]
