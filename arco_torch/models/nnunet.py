"""nnU-Net's Generic_UNet (counterpart of arco_tpu/models/nnunet.py), on
[B, C, H, W] or [B, C, X, Y, Z] tensors.

- Each block is conv -> dropout(p) -> affine InstanceNorm -> LeakyReLU(1e-2)
  (ConvDropoutNormNonlin, networks/nnunet.py:42-96). Its conv pads k // 2
  on both sides explicitly, also when it strides.
- Both downsampling variants: the first conv of a stage strides by the
  previous stage's pool kernel (``convolutional_pooling``), or a max pool
  follows each stage.
- Both upsampling variants: a transposed conv (kernel = stride = the pool
  kernel, no bias), or a half-pixel linear upsample (``align_corners=
  False``, as ``jax.image.resize(..., "linear")``).
- Optional dropout in the localization path, deep supervision, and
  ``upscale_logits``.
- Features are capped at 320 (3D) or 480 (2D).
- ``initialize_network`` is the reference's configuration
  (networks/nnunet.py:500-530): base 16, 2 convs a stage, 6 (3D) or 5 (2D)
  pools, convolutional pooling and upsampling, no deep supervision,
  dropout 0.

3D inputs keep the volume's axes in the JAX order, so the anisotropic
kernels below are JAX's, already depth-last: the reference checkpoints hold
them in (d, h, w) order, and arco_tpu/compat/torch_import_zoo.py's
``_nn_conv_dlast`` moves them to (h, w, d). The 3D lattice needs H and W
divisible by 64 and Z by 4, the 2D one H and W by 32. On other sizes the
forward fails, as JAX's does (the tiled predictor pads).

Forward contract: ``(logits, bottleneck, feature_maps)`` with the maps
[bottleneck, one per decoder stage] coarse -> fine. Under deep supervision
``logits`` is a tuple: the final head, then the aux heads coarse -> fine
reversed. Module names follow the reference's Generic_UNet as
torch_import_zoo.py reads them: ``conv_blocks_context.{d}.blocks.{j}`` (the
bottleneck ``conv_blocks_context.{num_pool}.{0,1}.blocks.*``),
``conv_blocks_localization.{u}.{0,1}.blocks.*``, ``tu.{u}``,
``seg_outputs.{u}``; each block's ``conv`` and ``instnorm``. Only the live
heads exist: ``seg_outputs`` holds the finest one unless deep supervision
is on, as in flax. Dropout masks can be passed in (``dropout_masks``, in
call order: every block of the context path, then of the localization path
when ``dropout_in_localization``), else they are drawn from ``generator``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import CONV, _CONV_T, DropoutDraws, \
    InstanceNorm
from arco_torch.ops.interpolate import resize_bilinear

DEFAULT_POOL_KERNELS = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2),
                        (2, 2, 1), (2, 2, 1))
DEFAULT_CONV_KERNELS = ((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3),
                        (3, 3, 3), (3, 3, 3), (3, 3, 3))
MAX_FEATURES_3D = 320
MAX_FEATURES_2D = 480


class InstanceNormAffine(InstanceNorm):
    """InstanceNorm with a learned per-channel scale and shift
    (norm_op_kwargs affine=True, nnunet.py:517), applied in the
    statistics' dtype and cast back, as JAX computes it."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(eps)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (self.normalize(x) * self.weight.view(shape)
                + self.bias.view(shape)).to(x.dtype)


class ConvNormLRelu(nn.Module):
    """ConvDropoutNormNonlin (nnunet.py:42-96)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=None,
                 dropout_p: float = 0.0):
        super().__init__()
        kernel = tuple(kernel)
        self.conv = CONV[len(kernel)](
            in_ch, out_ch, kernel, stride=tuple(stride or (1,) * len(kernel)),
            padding=tuple(k // 2 for k in kernel))
        self.instnorm = InstanceNormAffine(out_ch)
        self.dropout_p = float(dropout_p)

    def forward(self, x, draws: DropoutDraws):
        x = draws.dropout(self.conv(x), self.dropout_p)
        return F.leaky_relu(self.instnorm(x), 1e-2)


class StackedConvLayers(nn.Module):
    """``num_convs`` blocks; the first may stride (nnunet.py:98-160)."""

    def __init__(self, in_ch: int, out_ch: int, num_convs: int, kernel,
                 first_stride=None, dropout_p: float = 0.0):
        super().__init__()
        self.blocks = nn.ModuleList(
            [ConvNormLRelu(in_ch, out_ch, kernel, first_stride, dropout_p)]
            + [ConvNormLRelu(out_ch, out_ch, kernel, None, dropout_p)
               for _ in range(num_convs - 1)])

    def forward(self, x, draws: DropoutDraws):
        for block in self.blocks:
            x = block(x, draws)
        return x


class _Stages(nn.Sequential):
    """Two StackedConvLayers run one after the other (the bottleneck and
    each localization stage: ``.0`` and ``.1``)."""

    def forward(self, x, draws: DropoutDraws):
        return self[1](self[0](x, draws), draws)


class GenericUNet(nn.Module):
    """nnU-Net trunk; the fields are those of arco_tpu's GenericUNet, with
    the kernels' rank choosing 2D or 3D."""

    def __init__(self, input_channels: int = 1, base_num_features: int = 16,
                 num_classes: int = 3,
                 pool_kernels: Sequence[Tuple[int, ...]] =
                 DEFAULT_POOL_KERNELS,
                 conv_kernels: Sequence[Tuple[int, ...]] =
                 DEFAULT_CONV_KERNELS,
                 conv_per_stage: int = 2, max_features: int = MAX_FEATURES_3D,
                 deep_supervision: bool = False, dropout_p: float = 0.0,
                 dropout_in_localization: bool = False,
                 upscale_logits: bool = False,
                 convolutional_pooling: bool = True,
                 convolutional_upsampling: bool = True,
                 seg_output_use_bias: bool = False):
        super().__init__()
        self.pool_kernels = [tuple(p) for p in pool_kernels]
        self.spatial_dims = len(self.pool_kernels[0])
        self.deep_supervision = deep_supervision
        self.upscale_logits = upscale_logits
        self.convolutional_pooling = convolutional_pooling
        self.convolutional_upsampling = convolutional_upsampling
        n = len(self.pool_kernels)
        features = [min(base_num_features * 2 ** i, max_features)
                    for i in range(n + 1)]
        loc_p = dropout_p if dropout_in_localization else 0.0

        self.conv_blocks_context = nn.ModuleList()
        cin = input_channels
        for d in range(n):
            stride = self.pool_kernels[d - 1] \
                if d != 0 and convolutional_pooling else None
            self.conv_blocks_context.append(StackedConvLayers(
                cin, features[d], conv_per_stage, conv_kernels[d], stride,
                dropout_p))
            cin = features[d]
        # bottleneck (nnunet.py:326-341): conv_per_stage - 1 convs (the
        # first strided), then one whose width depends on the upsampling
        final = features[n] if convolutional_upsampling else features[n - 1]
        stride = self.pool_kernels[-1] if convolutional_pooling else None
        self.conv_blocks_context.append(_Stages(
            StackedConvLayers(cin, features[n], conv_per_stage - 1,
                              conv_kernels[n], stride, dropout_p),
            StackedConvLayers(features[n], final, 1, conv_kernels[n], None,
                              dropout_p)))
        self.latent_channels = final

        self.tu = nn.ModuleList()
        self.conv_blocks_localization = nn.ModuleList()
        heads = {}
        h = final
        for u in range(n):
            d = n - 1 - u
            n_skip = features[d]
            if convolutional_upsampling:
                self.tu.append(_CONV_T[self.spatial_dims](
                    h, n_skip, self.pool_kernels[d],
                    stride=self.pool_kernels[d], bias=False))
                h, out = n_skip, n_skip
            else:
                # the last conv reduces to the next level's width, so the
                # upsampled map matches the next skip
                out = features[d - 1] if u != n - 1 else n_skip
            # the localization kernel is one stage coarser than the skip's
            # (conv_kernel_sizes[-(u+1)], nnunet.py:370-371)
            kern = conv_kernels[d + 1]
            self.conv_blocks_localization.append(_Stages(
                StackedConvLayers(h + n_skip, n_skip, conv_per_stage - 1,
                                  kern, None, loc_p),
                StackedConvLayers(n_skip, out, 1, kern, None, loc_p)))
            h = out
            if deep_supervision or u == n - 1:
                heads[str(u)] = CONV[self.spatial_dims](
                    out, num_classes, 1, bias=seg_output_use_bias)
        self.seg_outputs = nn.ModuleDict(heads)

    def forward(self, x, dropout_masks=None, generator=None):
        draws = DropoutDraws(dropout_masks, generator, self.training)
        n = len(self.pool_kernels)
        pool = {2: F.max_pool2d, 3: F.max_pool3d}[self.spatial_dims]
        skips = []
        h = x
        for d in range(n):
            h = self.conv_blocks_context[d](h, draws)
            skips.append(h)
            if not self.convolutional_pooling:
                k = self.pool_kernels[d]
                h = pool(h, k, k)
        h = self.conv_blocks_context[n](h, draws)
        bottleneck = h
        feature_maps = [h]
        seg = []
        for u in range(n):
            d = n - 1 - u
            if self.convolutional_upsampling:
                h = self.tu[u](h)
            else:
                h = resize_bilinear(h, tuple(s * f for s, f in zip(
                    h.shape[2:], self.pool_kernels[d])), align_corners=False)
            h = self.conv_blocks_localization[u](
                torch.cat([h, skips[d]], dim=1), draws)
            feature_maps.append(h)
            if str(u) in self.seg_outputs:
                seg.append(self.seg_outputs[str(u)](h))
        if not self.deep_supervision:
            return seg[-1], bottleneck, feature_maps
        aux = seg[:-1][::-1]
        if self.upscale_logits:
            aux = [resize_bilinear(s, x.shape[2:], align_corners=False)
                   for s in aux]
        return tuple([seg[-1]] + aux), bottleneck, feature_maps


def initialize_network(num_classes: int = 2, threeD: bool = True,
                       input_channels: int = 1) -> GenericUNet:
    """networks/nnunet.py:500-530: base 16 features, the default kernels,
    convolutional pooling and upsampling, no deep supervision, dropout 0."""
    if threeD:
        return GenericUNet(input_channels=input_channels,
                           num_classes=num_classes)
    return GenericUNet(
        input_channels=input_channels, num_classes=num_classes,
        max_features=MAX_FEATURES_2D,
        pool_kernels=tuple((2, 2) for _ in range(5)),
        conv_kernels=tuple((3, 3) for _ in range(6)))
