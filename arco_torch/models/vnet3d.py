"""3D V-Net, ARCO's main 3D backbone (counterpart of
arco_tpu/models/vnet3d.py:VNet), NCDHW.

Inputs are [B, C, X, Y, Z] with the LA volume's axes in the JAX order
([B, X, Y, Z, C] there), so weights move by a permute. Five encoder stages
with conv-stride-2 downsampling, transposed-conv upsampling, residual-add
skips in the decoder, BatchNorm and ReLU, dropout p=0.5 at the bottleneck
(x5) and before the head (x9) when ``has_dropout``.

Forward contract: ``(logits, feature_map[0], feature_map)`` with the five
decoder maps coarse -> fine, channels [128, 64, 32, 16, 16] for
n_filters=16. Module names follow networks/vnetWithArgs.py (block_one ..
block_nine with ``conv.{3i, 3i+1}`` per stage, block_{one..four}_dw and
block_{five..eight}_up with ``conv.{0, 1}``, out_conv), as
arco_tpu/compat/torch_import.py:convert_vnet_state_dict reads them, so
reference checkpoints load by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from arco_torch.models.layers import BatchNorm3d, ConvTransposeUp, dropout

_NAMES = ("one", "two", "three", "four", "five", "six", "seven", "eight",
          "nine")


class _ConvBlock(nn.Module):
    """n_stages x (Conv3 + BN + ReLU) (vnetWithArgs.py:5-31)."""

    def __init__(self, n_stages: int, in_ch: int, out_ch: int):
        super().__init__()
        ops = []
        for i in range(n_stages):
            ops += [nn.Conv3d(in_ch if i == 0 else out_ch, out_ch, 3,
                              padding=1), BatchNorm3d(out_ch), nn.ReLU()]
        self.conv = nn.Sequential(*ops)

    def forward(self, x):
        return self.conv(x)


class _Resample(nn.Module):
    """Conv (down) or transposed conv (up), kernel 2 and stride 2, + BN +
    ReLU (vnetWithArgs.py:67-117)."""

    def __init__(self, in_ch: int, out_ch: int, up: bool):
        super().__init__()
        conv = ConvTransposeUp(in_ch, out_ch, 3) if up \
            else nn.Conv3d(in_ch, out_ch, 2, stride=2)
        self.conv = nn.Sequential(conv, BatchNorm3d(out_ch), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class VNet(nn.Module):
    spatial_dims = 3

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 n_filters: int = 16, has_dropout: bool = True):
        super().__init__()
        self.n_classes = n_classes
        self.has_dropout = has_dropout
        nf = n_filters
        # (stages, in, out) of block_one .. block_nine
        blocks = ((1, n_channels, nf), (2, 2 * nf, 2 * nf),
                  (3, 4 * nf, 4 * nf), (3, 8 * nf, 8 * nf),
                  (3, 16 * nf, 16 * nf), (3, 8 * nf, 8 * nf),
                  (3, 4 * nf, 4 * nf), (2, 2 * nf, 2 * nf), (1, nf, nf))
        for name, (n, cin, cout) in zip(_NAMES, blocks):
            setattr(self, f"block_{name}", _ConvBlock(n, cin, cout))
        for i, name in enumerate(_NAMES[:4]):
            setattr(self, f"block_{name}_dw",
                    _Resample(nf * 2 ** i, nf * 2 ** (i + 1), up=False))
        for i, name in enumerate(_NAMES[4:8]):
            setattr(self, f"block_{name}_up",
                    _Resample(nf * 2 ** (4 - i), nf * 2 ** (3 - i), up=True))
        self.out_conv = nn.Conv3d(nf, n_classes, 1)

    def _drop_shapes(self, x_shape):
        """The shapes of the two dropout sites' inputs, x5 then x9."""
        b, _, *s = x_shape
        nf = self.block_nine.conv[0].out_channels
        return [(b, 16 * nf, *(d // 16 for d in s)), (b, nf, *s)]

    def draw_dropout_masks(self, x_shape, generator=None, device=None):
        """The keep-masks (x5, x9) that a train-mode forward of an input of
        ``x_shape`` draws from ``generator``, in its order; None when the
        forward draws none."""
        if not (self.training and self.has_dropout):
            return [None, None]
        return [torch.rand(shape, generator=generator, device=device) < 0.5
                for shape in self._drop_shapes(x_shape)]

    def forward(self, x, dropout_masks=None, generator=None):
        """``dropout_masks``: optional [x5 mask, x9 mask] (None entries draw
        from ``generator``)."""
        masks = dropout_masks or [None, None]
        drop = lambda t, m: dropout(t, 0.5, m, generator,
                                    self.training and self.has_dropout)
        x1 = self.block_one(x)
        x2 = self.block_two(self.block_one_dw(x1))
        x3 = self.block_three(self.block_two_dw(x2))
        x4 = self.block_four(self.block_three_dw(x3))
        x5 = drop(self.block_five(self.block_four_dw(x4)), masks[0])

        feature_map = []
        x = self.block_five_up(x5) + x4
        feature_map.append(x)
        x = self.block_six_up(self.block_six(x)) + x3
        feature_map.append(x)
        x = self.block_seven_up(self.block_seven(x)) + x2
        feature_map.append(x)
        x = self.block_eight_up(self.block_eight(x)) + x1
        feature_map.append(x)
        x9 = self.block_nine(x)
        feature_map.append(x9)
        logits = self.out_conv(drop(x9, masks[1]))
        return logits, feature_map[0], feature_map
