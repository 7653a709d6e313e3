"""TransUNet (R50-ViT-B/16 hybrid): a ViT encoder over ResNet features with
a cascaded upsampling decoder (counterpart of
arco_tpu/models/transunet.py; reference networks/vit_seg_modeling.py:
248-457 with the 'R50-ViT-B_16' config), NCHW.

ResNet-v2 stem (width 64, units 3/4/9, weight-standardized convs and
GroupNorm 32), 1x1 patch embedding of the stride-16 map, ``num_layers``
pre-LN transformer blocks, the DecoderCup (a 512-channel 3x3 conv, four
decoder blocks with the stem's skips) and a 3x3 head. Grayscale input is
repeated to three channels. No ImageNet weights (as in JAX).

Flax's defaults kept: LayerNorm and GroupNorm eps 1e-6, the tanh GELU,
"SAME" strided convs padded as flax pads them (the 7x7/s2 root (2, 3),
3x3/s2 (0, 1)), the root max pool over an explicit zero pad. Attention is
``F.scaled_dot_product_attention`` (flax's MHA: softmax(q k^T / sqrt(d))
v per head); its dropout rate is 0 in the reference config, and the port
takes no other. The position embedding has one row per token of an
``img_size`` input, as JAX's takes the shape of its init input.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import BatchNorm2d, DropoutDraws, same_pad
from arco_torch.ops.interpolate import resize_bilinear


def _pair(size):
    return (size, size) if isinstance(size, int) else tuple(size)


class StdConv(nn.Conv2d):
    """Weight-standardized conv (vit_seg_modeling_resnet_skip.py): the
    kernel standardized over each output channel's (in, h, w) values with
    eps 1e-5, "SAME" padding for any stride."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, bias=False):
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)

    def forward(self, x):
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3),
                                   keepdim=True, correction=0)
        w = (self.weight - mean) / torch.sqrt(var + 1e-5)
        x = same_pad(x, self.kernel_size, self.stride[0])
        return F.conv2d(x, w, self.bias, self.stride)


def _gn(ch):
    return nn.GroupNorm(32, ch, eps=1e-6)


class PreActBottleneck(nn.Module):
    """GroupNorm bottleneck (vit_seg_modeling_resnet_skip.py): 1x1 -> 3x3/s
    -> 1x1, the residual through a 1x1/s StdConv + GroupNorm when the shape
    changes."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        if cin != cout or stride != 1:
            self.downsample = StdConv(cin, cout, 1, stride=stride)
            self.gn_proj = _gn(cout)
        self.conv1, self.gn1 = StdConv(cin, cmid, 1), _gn(cmid)
        self.conv2, self.gn2 = StdConv(cmid, cmid, 3, stride=stride), \
            _gn(cmid)
        self.conv3, self.gn3 = StdConv(cmid, cout, 1), _gn(cout)

    def forward(self, x):
        residual = x
        if hasattr(self, "downsample"):
            residual = self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(residual + y)


class ResNetV2Stem(nn.Module):
    """The 3-stage hybrid stem; returns (the stride-16 map, [skip at
    stride 8, skip at stride 4])."""

    def __init__(self, in_chns: int = 3, width: int = 64,
                 units: Sequence[int] = (3, 4, 9)):
        super().__init__()
        self.root_conv = StdConv(in_chns, width, 7, stride=2)
        self.root_gn = _gn(width)
        self.stages = nn.ModuleList()
        cin = width
        for stage, (n_units, cout) in enumerate(
                zip(units, (width * 4, width * 8, width * 16))):
            stride = 1 if stage == 0 else 2
            blocks = [PreActBottleneck(cin, cout, cout // 4, stride)]
            blocks += [PreActBottleneck(cout, cout, cout // 4)
                       for _ in range(n_units - 1)]
            self.stages.append(nn.Sequential(*blocks))
            cin = cout
        self.skip_channels = (width * 8, width * 4)

    def forward(self, x):
        h = F.relu(self.root_gn(self.root_conv(x)))
        h = F.max_pool2d(F.pad(h, (1, 1, 1, 1)), 3, stride=2)
        skips = []
        for stage, blocks in enumerate(self.stages):
            h = blocks(h)
            if stage < 2:
                skips.append(h)
        return h, skips[::-1]


class Attention(nn.Module):
    """flax's MultiHeadDotProductAttention with qkv_features = hidden:
    query/key/value/out projections with bias."""

    def __init__(self, hidden: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, n, c = x.shape
        split = lambda t: t.reshape(b, n, self.num_heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)))
        return self.out(o.transpose(1, 2).reshape(b, n, c))


class TransformerBlock(nn.Module):
    """Pre-LN block with the reference's dropout placement
    (vit_seg_modeling.py:85-130): after the attention's output projection
    and after both MLP denses."""

    def __init__(self, hidden: int = 768, mlp_dim: int = 3072,
                 num_heads: int = 12, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.attn = Attention(hidden, num_heads)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)

    def forward(self, x, draws: DropoutDraws):
        p = self.dropout_rate
        x = x + draws.dropout(self.attn(self.attention_norm(x)), p)
        h = F.gelu(self.fc1(self.ffn_norm(x)), approximate="tanh")
        h = self.fc2(draws.dropout(h, p))
        return x + draws.dropout(h, p)


class DecoderBlock(nn.Module):
    """2x bilinear upsample (align_corners=False), concat the skip, two 3x3
    conv + BN + ReLU (DecoderCup, vit_seg_modeling.py:327-372)."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch + skip_ch, out_ch, 3, padding=1,
                               bias=False)
        self.bn1 = BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_ch)

    def forward(self, x, skip=None):
        x = resize_bilinear(x, tuple(2 * s for s in x.shape[2:]),
                            align_corners=False)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class VisionTransformerSeg(nn.Module):
    """'ViT_Seg' (net_factory_args.py:29-31): returns (logits, the
    [B, hidden, H/16, W/16] token map, the five decoder maps [512, 256,
    128, 64, 16]). ``dropout_masks``: the keep-masks of the token dropout
    and of each block's three dropouts, in order, on [B, tokens, width]
    (DropoutDraws)."""

    def __init__(self, img_size=256, num_classes: int = 4,
                 in_chns: int = 1, hidden: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16),
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0):
        super().__init__()
        if attention_dropout_rate:
            raise NotImplementedError(
                "attention dropout: the reference config's rate is 0")
        self.num_classes = num_classes
        self.latent_channels = hidden
        self.dropout_rate = dropout_rate
        self.grid = tuple(s // 16 for s in _pair(img_size))
        self.resnet = ResNetV2Stem(3 if in_chns == 1 else in_chns)
        self.patch_embeddings = nn.Conv2d(1024, hidden, 1)
        self.pos_embedding = nn.Parameter(
            0.02 * torch.randn(1, self.grid[0] * self.grid[1], hidden))
        self.layers = nn.ModuleList(
            TransformerBlock(hidden, mlp_dim, num_heads, dropout_rate)
            for _ in range(num_layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.conv_more = nn.Conv2d(hidden, 512, 3, padding=1, bias=False)
        self.conv_more_bn = BatchNorm2d(512)
        skips = list(self.resnet.skip_channels) + [0, 0]
        blocks, cin = [], 512
        for ch, skip in zip(decoder_channels, skips):
            blocks.append(DecoderBlock(cin, skip, ch))
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.segmentation_head = nn.Conv2d(cin, num_classes, 3, padding=1)

    def forward(self, x, dropout_masks=None, generator=None):
        draws = DropoutDraws(dropout_masks, generator, self.training)
        if x.shape[1] == 1:      # the reference repeats grayscale
            x = x.repeat(1, 3, 1, 1)
        feats, skips = self.resnet(x)
        h = self.patch_embeddings(feats)
        b, c, gh, gw = h.shape
        if (gh, gw) != self.grid:
            raise ValueError(f"ViT_Seg was built for a {self.grid} token "
                             f"grid (img_size), got {(gh, gw)}")
        tokens = h.flatten(2).transpose(1, 2) + self.pos_embedding
        tokens = draws.dropout(tokens, self.dropout_rate)
        for layer in self.layers:
            tokens = layer(tokens, draws)
        tokens = self.encoder_norm(tokens)
        latent = tokens.transpose(1, 2).reshape(b, c, gh, gw)

        d = F.relu(self.conv_more_bn(self.conv_more(latent)))
        feature_map = [d]
        for block, skip in zip(self.blocks, skips + [None, None]):
            d = block(d, skip)
            feature_map.append(d)
        return self.segmentation_head(d), latent, feature_map
