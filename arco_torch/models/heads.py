"""Heads of both stages (counterpart of arco_tpu/models/heads.py).

Stage 2: FeatureExtractor, QRepresentation. Stage 1 (ISD): ProjectionHead,
LatentMLP, LatentPredictor, OutputsPredictor; and RepresentationHead.

The 1x1-conv heads compute as matrix products over the channel dim of
channels-last [B, *spatial, C] tensors (2D or 3D): the fused representation
comes out channels-last and contiguous, which is the layout the contrastive
loss and the random pool flatten ([rows, C] and [B, prod(spatial)*C]) in
JAX's raster order with no copy, and the
ISD descriptors flatten each pooled cell in JAX's (h, w, c) order. Weights
keep the reference's conv shapes ([out, in, 1, 1] or [out, in, 1, 1, 1]
for ``nd=3``; ``fea{i}.weight``);
the stacked heads name their layers by position (``{i}.weight``), as
flax's ``Conv_{i}`` / ``Dense_{i}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import CONV, adaptive_avg_pool
from arco_torch.ops.interpolate import resize_bilinear


def _nhwc(x):
    """[B, C, *spatial] -> channels-last [B, *spatial, C] (a view)."""
    return x.movedim(1, -1)


def _conv1x1(x, conv):
    """A 1x1 ``conv`` over the channel dim of channels-last ``x``."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _resize_nhwc(z, size):
    """Bi/trilinear resize (align_corners) of channels-last ``z``."""
    return _nhwc(resize_bilinear(z.movedim(-1, 1), size, align_corners=True))



class FeatureExtractor(nn.Module):
    """Pyramid fuser in its composed-kernel form.

    The reference cascade x0 = (W0+I) m0, x_i = (W_i+I) [up(x_{i-1}); m_i],
    y = W4 [up(x_3); m_4] is channel-linear, so composing the kernels gives
    the same function as y = up(...up(m0 B0) + m1 B1 ...) + m4 B4 with small
    [c_i, out] matrices B_i (derivation in arco_tpu/models/heads.py).
    Input: [B, C, *spatial] decoder maps coarse -> fine, ``nd`` spatial
    dims; output [B, *spatial, output_dim]."""

    def __init__(self, fea_dim: Sequence[int] = (256, 128, 64, 32, 16),
                 output_dim: int = 256, nd: int = 2):
        super().__init__()
        c = [int(d) for d in fea_dim]
        n = len(c)
        assert n >= 2
        d = [sum(c[:i + 1]) for i in range(n)]
        self.fea_dim, self.output_dim = c, output_dim
        conv = CONV[nd]
        self.fea0 = conv(c[0], c[0], 1, bias=False)
        for i in range(1, n - 1):
            setattr(self, f"fea{i}", conv(d[i], d[i], 1, bias=False))
        setattr(self, f"fea{n - 1}",
                conv(d[n - 1], output_dim, 1, bias=False))

    def composed_kernels(self):
        """B_i [c_i, output_dim] in f32 (differentiable in the weights),
        composed outside autocast as JAX composes them before the cast to
        the compute dtype."""
        c = self.fea_dim
        n = len(c)
        d = [sum(c[:i + 1]) for i in range(n)]
        dev = self.fea0.weight.device
        with torch.autocast(dev.type, enabled=False):
            # K_i as [in, out] matrices, the flax kernel layout
            K = [getattr(self, f"fea{i}").weight.flatten(1).float().t()
                 for i in range(n)]
            eye = lambda m: torch.eye(m, dtype=torch.float32, device=dev)
            A = K[n - 1][:d[n - 2]]
            B = [None] * n
            B[n - 1] = K[n - 1][d[n - 2]:]
            for i in range(n - 2, 0, -1):
                M = (K[i] + eye(d[i])) @ A
                A, B[i] = M[:d[i - 1]], M[d[i - 1]:]
            B[0] = (K[0] + eye(c[0])) @ A
        return B

    def forward(self, fea_list):
        assert len(fea_list) == len(self.fea_dim)
        B = self.composed_kernels()
        dt = fea_list[0].dtype            # the compute dtype of the maps
        z = _nhwc(fea_list[0]).to(dt) @ B[0].to(dt)
        for f, b in zip(fea_list[1:], B[1:]):
            z = _resize_nhwc(z, tuple(f.shape[2:]))
            z = z + _nhwc(f).to(dt) @ b.to(dt)
        return z


class _Conv1x1Stack(nn.Sequential):
    """1x1 convs applied in turn over the channel dim of channels-last x."""

    def forward(self, x):
        for conv in self:
            x = _conv1x1(x, conv)
        return x


class QRepresentation(_Conv1x1Stack):
    """Two bias-free 1x1 convs over the fused channels-last map
    (train_arco_2d.py:231-235, train_arco_3d.py:208-211)."""

    def __init__(self, channels: int = 256 + 128 + 64 + 32 + 16,
                 nd: int = 2):
        conv = CONV[nd]
        super().__init__(conv(channels, channels, 1, bias=False),
                         conv(channels, channels, 1, bias=False))


class ProjectionHead(_Conv1x1Stack):
    """AdaptiveAvgPool to ``output_pooling_size``, then 1x1 convs in -> 2*in
    -> proj_dim (``proj="convmlp"``) or one 1x1 conv in -> proj_dim
    (``"linear"``, no pool), over channels-last [N, H, W, C]
    (model_2D.py:67-92)."""

    def __init__(self, in_channels: int, proj_dim: int = 4,
                 output_pooling_size: int = 16, proj: str = "convmlp"):
        if proj == "linear":
            convs = [nn.Conv2d(in_channels, proj_dim, 1)]
        else:
            convs = [nn.Conv2d(in_channels, 2 * in_channels, 1),
                     nn.Conv2d(2 * in_channels, proj_dim, 1)]
        super().__init__(*convs)
        self.output_pooling_size = output_pooling_size
        self.proj = proj

    def forward(self, x, pre_pooled: bool = False):
        """``pre_pooled``: the caller already pooled x to
        output_pooling_size (ops.patches.pooled_patch_grid)."""
        if self.proj != "linear" and not pre_pooled:
            x = _nhwc(adaptive_avg_pool(x.permute(0, 3, 1, 2),
                                        self.output_pooling_size))
        return super().forward(x)


class RepresentationHead(nn.Sequential):
    """3x3 conv (no bias) + 1x1 conv, NCHW in and out (model_2D.py:87-95)."""

    def __init__(self, in_channels: int, output_channel: int = 512):
        super().__init__(
            nn.Conv2d(in_channels, output_channel, 3, padding=1, bias=False),
            nn.Conv2d(output_channel, output_channel, 1))


class LatentMLP(nn.Sequential):
    """The latent head: AdaptiveAvgPool to ``pooling_size`` of the NCHW
    bottleneck, flattened in (h, w, c) order as JAX flattens its
    channels-last map, then two Linear layers (model_2D.py:98-112)."""

    def __init__(self, input_channels: int = 256, num_class: int = 128,
                 pooling_size: int = 1):
        super().__init__(
            nn.Linear(input_channels * pooling_size ** 2, input_channels),
            nn.Linear(input_channels, num_class))
        self.pooling_size = pooling_size

    def forward(self, x):
        x = _nhwc(adaptive_avg_pool(x, self.pooling_size))
        return super().forward(x.reshape(x.shape[0], -1))


class LatentPredictor(nn.Sequential):
    """Two Linear layers (model_2D.py:146-151)."""

    def __init__(self, feature_size: int = 512):
        super().__init__(nn.Linear(feature_size, feature_size),
                         nn.Linear(feature_size, feature_size))


class OutputsPredictor(_Conv1x1Stack):
    """Two 1x1 convs with bias over channels-last class maps
    (model_2D.py:157-160)."""

    def __init__(self, num_classes: int = 4):
        super().__init__(nn.Conv2d(num_classes, num_classes, 1),
                         nn.Conv2d(num_classes, num_classes, 1))
