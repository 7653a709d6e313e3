"""Çiçek-style 3D U-Net, its deep-supervised semi variant and the
grid-attention U-Net (counterpart of arco_tpu/models/unet3d.py), NCDHW.

- ``UNet3D`` (networks/unet_3D.py:20-100): filters [64, 128, 256, 512,
  1024] / feature_scale, UnetConv3 double-conv blocks, trilinear-upsample
  UnetUp3_CT decoder, dropout 0.3 at the bottleneck and before the head.
- ``UNet3DDVSemi`` (networks/unet_3D_dv_semi.py:13-112): the same trunk
  with channel dropout after each decoder block and four deep-supervision
  heads, returned fine -> coarse.
- ``AttentionUNet3D`` (networks/attention_unet.py:9-135): the trunk with
  two grid-attention gates a skip (``MultiAttentionBlock``) on skips 2-4,
  a gating signal from the bottleneck, and a deep-supervision head.
- ``GridAttentionBlockTORR`` (grid_attention_layer.py:183-357), 2D or 3D.

Inputs are [B, C, X, Y, Z] with the volume's axes in the JAX order ([B, X,
Y, Z, C] there). Module names follow the reference as
arco_tpu/compat/torch_import_zoo.py reads them (``conv1..4``, ``center``,
``up_concat4..1`` with ``.conv``, ``final``, ``dsv1`` and ``dsv{2,3,4}.dsv.0``,
``gating.conv1.0``, ``attentionblock{4,3,2}.gate_block_{1,2}`` with
``theta/phi/psi/W``, ``combine_gates``), so reference checkpoints load by
name. The normalization of UnetConv3 is a non-affine InstanceNorm (what
networks/utils.py:104-109 builds for ``is_batchnorm=True``); the attention
blocks' BatchNorm follows flax's running-statistics rule
(models/layers.py). Every dropout mask can be passed in (``dropout_masks``)
or is drawn from ``generator``; ``draw_dropout_masks`` draws them in the
forward's order.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import CONV, _BN, InstanceNorm, dropout
from arco_torch.ops.interpolate import resize_bilinear


def _filters(feature_scale: int):
    return [int(f / feature_scale) for f in (64, 128, 256, 512, 1024)]


def _conv_in_relu(in_ch: int, out_ch: int, kernel: int):
    return nn.Sequential(nn.Conv3d(in_ch, out_ch, kernel,
                                   padding=kernel // 2),
                         InstanceNorm(), nn.ReLU())


class UnetConv3(nn.Module):
    """Two (Conv 3x3x3 + InstanceNorm + ReLU) (networks/utils.py:99-124)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = _conv_in_relu(in_ch, out_ch, 3)
        self.conv2 = _conv_in_relu(out_ch, out_ch, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UnetUp3CT(nn.Module):
    """Trilinear upsample (align_corners=False, nn.Upsample's default) of
    ``x`` to the skip's size, concat [skip, x], UnetConv3
    (networks/utils.py:260-278)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = UnetConv3(in_ch + out_ch, out_ch)

    def forward(self, skip, x):
        x = resize_bilinear(x, tuple(skip.shape[2:]), align_corners=False)
        return self.conv(torch.cat([skip, x], dim=1))


class UnetDsv3(nn.Module):
    """A deep-supervision head: 1x1x1 conv, trilinear resize to the input's
    size (networks/utils.py:455-462)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.dsv = nn.Sequential(nn.Conv3d(in_ch, out_ch, 1))

    def forward(self, x, size):
        return resize_bilinear(self.dsv(x), size, align_corners=False)


_UPS = ("up_concat4", "up_concat3", "up_concat2", "up_concat1")


class _Trunk(nn.Module):
    """conv1..conv4 with a 2x max pool after each, center, and the decoder
    blocks up_concat4..up_concat1 that each model runs its own way."""

    spatial_dims = 3

    def __init__(self, in_channels: int, feature_scale: int):
        super().__init__()
        f = _filters(feature_scale)
        self.filters = f
        chans = [in_channels] + f
        for i in range(4):
            setattr(self, f"conv{i + 1}", UnetConv3(chans[i], chans[i + 1]))
        self.center = UnetConv3(f[3], f[4])
        for i, name in enumerate(_UPS):
            setattr(self, name, UnetUp3CT(f[4 - i], f[3 - i]))
        self.latent_channels = f[4]

    def encode(self, x):
        """([conv1 .. conv4], center)."""
        convs = []
        for i in range(4):
            x = getattr(self, f"conv{i + 1}")(x)
            convs.append(x)
            x = F.max_pool3d(x, 2, 2)
        return convs, self.center(x)


class UNet3D(_Trunk):
    """Forward contract: ``(logits, center, feature_map)``, the decoder maps
    coarse -> fine: [center, up4, up3, up2, up1]."""

    def __init__(self, feature_scale: int = 4, n_classes: int = 21,
                 in_channels: int = 3):
        super().__init__(in_channels, feature_scale)
        self.final = nn.Conv3d(self.filters[0], n_classes, 1)

    def _drop_shapes(self, x_shape):
        b, _, *s = x_shape
        return [(b, self.filters[4], *(d // 16 for d in s)),
                (b, self.filters[0], *s)]

    def draw_dropout_masks(self, x_shape, generator=None, device=None):
        """The keep-masks (center, head) that a train-mode forward of an
        input of ``x_shape`` draws; None when it draws none."""
        if not self.training:
            return [None, None]
        return [torch.rand(shape, generator=generator, device=device) < 0.7
                for shape in self._drop_shapes(x_shape)]

    def forward(self, x, dropout_masks=None, generator=None):
        """``dropout_masks``: optional [center mask, head mask] (None
        entries draw from ``generator``)."""
        masks = dropout_masks or [None, None]
        convs, center = self.encode(x)
        center = dropout(center, 0.3, masks[0], generator, self.training)
        feature_map = [center]
        h = center
        for i, name in enumerate(_UPS):
            h = getattr(self, name)(convs[3 - i], h)
            feature_map.append(h)
        h = dropout(h, 0.3, masks[1], generator, self.training)
        return self.final(h), center, feature_map


class UNet3DDVSemi(_Trunk):
    """Forward: the four deep-supervision outputs fine -> coarse, each at
    the input's size. After each decoder block a channel dropout
    (Dropout3d, p 0.5 / 0.3 / 0.2 / 0.1) zeroes whole feature maps: its
    masks are [B, C, 1, 1, 1], broadcast over space as flax's
    ``broadcast_dims=(1, 2, 3)``."""

    DROP = (0.5, 0.3, 0.2, 0.1)

    def __init__(self, feature_scale: int = 4, n_classes: int = 21,
                 in_channels: int = 3):
        super().__init__(in_channels, feature_scale)
        f = self.filters
        self.dsv1 = nn.Conv3d(f[0], n_classes, 1)
        for k in (2, 3, 4):
            setattr(self, f"dsv{k}", UnetDsv3(f[k - 1], n_classes))

    def draw_dropout_masks(self, x_shape, generator=None, device=None):
        if not self.training:
            return [None] * 4
        b = x_shape[0]
        return [torch.rand((b, self.filters[3 - i], 1, 1, 1),
                           generator=generator, device=device) < 1.0 - p
                for i, p in enumerate(self.DROP)]

    def forward(self, x, dropout_masks=None, generator=None):
        masks = dropout_masks or [None] * 4
        size = tuple(x.shape[2:])
        convs, h = self.encode(x)
        ups = []
        for i, name in enumerate(_UPS):
            h = getattr(self, name)(convs[3 - i], h)
            mask = masks[i]
            if self.training and mask is None:
                mask = torch.rand(h.shape[:2] + (1, 1, 1),
                                  generator=generator,
                                  device=h.device) < 1.0 - self.DROP[i]
            # the dropped map feeds the next block, as in JAX
            h = dropout(h, self.DROP[i], mask, generator, self.training)
            ups.append(h)
        out = [self.dsv1(ups[3])]
        for k in (2, 3, 4):
            out.append(getattr(self, f"dsv{k}")(ups[4 - k], size))
        return tuple(out)


class GridAttentionBlock3D(nn.Module):
    """'concatenation' grid attention (grid_attention_layer.py:7-111):
    theta a kernel = stride = sub_sample conv without bias, phi and psi
    1x1x1 with bias, trilinear resizes (align_corners=False), and the
    output transform W = 1x1x1 conv + BatchNorm. Returns (W y, the
    attention map)."""

    def __init__(self, in_channels: int, gating_channels: int,
                 inter_channels: int, sub_sample=(2, 2, 2)):
        super().__init__()
        ss = tuple(sub_sample)
        self.theta = nn.Conv3d(in_channels, inter_channels, ss, stride=ss,
                               bias=False)
        self.phi = nn.Conv3d(gating_channels, inter_channels, 1)
        self.psi = nn.Conv3d(inter_channels, 1, 1)
        self.W = nn.Sequential(nn.Conv3d(in_channels, in_channels, 1),
                               _BN[3](in_channels))

    def forward(self, x, g):
        theta_x = self.theta(x)
        phi_g = resize_bilinear(self.phi(g), tuple(theta_x.shape[2:]),
                                align_corners=False)
        psi = self.psi(F.relu(theta_x + phi_g))
        sigm = torch.sigmoid(psi.float()).to(x.dtype)
        sigm = resize_bilinear(sigm, tuple(x.shape[2:]), align_corners=False)
        return self.W(sigm * x), sigm


class MultiAttentionBlock(nn.Module):
    """Two parallel attention gates and a combine conv (1x1x1 + BatchNorm +
    ReLU) over their concat (attention_unet.py:113-135)."""

    def __init__(self, in_size: int, gate_size: int, inter_size: int):
        super().__init__()
        self.gate_block_1 = GridAttentionBlock3D(in_size, gate_size,
                                                 inter_size)
        self.gate_block_2 = GridAttentionBlock3D(in_size, gate_size,
                                                 inter_size)
        self.combine_gates = nn.Sequential(
            nn.Conv3d(2 * in_size, in_size, 1), _BN[3](in_size), nn.ReLU())

    def forward(self, x, g):
        gate1, _ = self.gate_block_1(x, g)
        gate2, _ = self.gate_block_2(x, g)
        return self.combine_gates(torch.cat([gate1, gate2], dim=1))


class _GatingSignal(nn.Module):
    """Conv 1x1x1 + InstanceNorm + ReLU (UnetGridGatingSignal3,
    networks/utils.py:192-212)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = _conv_in_relu(in_ch, out_ch, 1)

    def forward(self, x):
        return self.conv1(x)


class AttentionUNet3D(_Trunk):
    """Forward contract: ``(logits, center, feature_map)``, the decoder maps
    coarse -> fine: [center, up4, up3, up2, up1]. No dropout: a passed
    ``dropout_masks`` is ignored."""

    def __init__(self, feature_scale: int = 4, n_classes: int = 21,
                 in_channels: int = 3):
        super().__init__(in_channels, feature_scale)
        f = self.filters
        self.gating = _GatingSignal(f[4], f[4])
        self.attentionblock4 = MultiAttentionBlock(f[3], f[4], f[3])
        self.attentionblock3 = MultiAttentionBlock(f[2], f[3], f[2])
        self.attentionblock2 = MultiAttentionBlock(f[1], f[2], f[1])
        self.dsv1 = nn.Conv3d(f[0], n_classes, 1)
        for k in (2, 3, 4):
            setattr(self, f"dsv{k}", UnetDsv3(f[k - 1], n_classes))
        self.final = nn.Conv3d(4 * n_classes, n_classes, 1)

    def draw_dropout_masks(self, x_shape, generator=None, device=None):
        return []

    def forward(self, x, dropout_masks=None, generator=None):
        size = tuple(x.shape[2:])
        convs, center = self.encode(x)
        gate = self.gating(center)
        g4 = self.attentionblock4(convs[3], gate)
        up4 = self.up_concat4(g4, center)
        g3 = self.attentionblock3(convs[2], up4)
        up3 = self.up_concat3(g3, up4)
        g2 = self.attentionblock2(convs[1], up3)
        up2 = self.up_concat2(g2, up3)
        up1 = self.up_concat1(convs[0], up2)
        dsv = [self.dsv1(up1)] + [getattr(self, f"dsv{k}")(u, size)
                                  for k, u in ((2, up2), (3, up3), (4, up4))]
        logits = self.final(torch.cat(dsv, dim=1))
        return logits, center, [center, up4, up3, up2, up1]


_TORR_MODES = ("concatenation", "concatenation_sigmoid",
               "concatenation_softmax", "concatenation_mean",
               "concatenation_mean_flow", "concatenation_range_normalise")


class GridAttentionBlockTORR(nn.Module):
    """TORR grid-attention variants (grid_attention_layer.py:183-357) over
    ``nd`` (2 or 3) spatial dims. theta and phi are kernel = stride =
    sub_sample convs without bias (the sizes must divide by sub_sample),
    every projection can be left out (identity), W has an optional
    BatchNorm, and the attention is normalized by ``mode``: sigmoid (and
    'concatenation'), softmax, mean, mean_flow or range_normalise over the
    flattened spatial axes. psi's bias starts at 3.0 (sigmoid) or 10.0
    (softmax), else 0 (:266-270); resizes are (bi/tri)linear with
    align_corners=True. Returns (W y, the attention map)."""

    def __init__(self, in_channels: int, gating_channels: int,
                 inter_channels: int, mode: str = "concatenation_sigmoid",
                 sub_sample: int = 1, use_w: bool = True,
                 use_phi: bool = True, use_theta: bool = True,
                 use_psi: bool = True, bn_layer: bool = True,
                 nonlinearity1: str = "relu", nd: int = 3):
        super().__init__()
        if mode not in _TORR_MODES:
            raise NotImplementedError(mode)
        self.mode, self.nonlinearity1 = mode, nonlinearity1
        conv = CONV[nd]
        ss = sub_sample
        self.theta = conv(in_channels, inter_channels, ss, stride=ss,
                          bias=False) if use_theta else None
        self.phi = conv(gating_channels, inter_channels, ss, stride=ss,
                        bias=False) if use_phi else None
        self.psi = None
        if use_psi:
            self.psi = conv(inter_channels, 1, 1)
            # JAX's bias_init; jax_init_ keeps it (models/init.py)
            self.psi.jax_bias = {"concatenation_sigmoid": 3.0,
                                 "concatenation_softmax": 10.0}.get(mode, 0.0)
            nn.init.constant_(self.psi.bias, self.psi.jax_bias)
        self.W = None
        if use_w:
            w = conv(in_channels, in_channels, 1)
            self.W = nn.Sequential(w, _BN[nd](in_channels)) if bn_layer \
                else w

    def forward(self, x, g):
        theta_x = self.theta(x) if self.theta is not None else x
        phi_g = self.phi(g) if self.phi is not None else g
        phi_g = resize_bilinear(phi_g, tuple(theta_x.shape[2:]),
                                align_corners=True)
        f = theta_x + phi_g
        if self.nonlinearity1 == "relu":
            f = F.relu(f)
        psi_f = self.psi(f) if self.psi is not None else f
        if self.mode in ("concatenation_sigmoid", "concatenation"):
            sigm = torch.sigmoid(psi_f.float()).to(x.dtype)
        else:
            flat = psi_f.reshape(psi_f.shape[0], -1).float()
            if self.mode == "concatenation_softmax":
                att = torch.softmax(flat, dim=1)
            elif self.mode == "concatenation_mean":
                att = flat / flat.sum(1, keepdim=True)
            elif self.mode == "concatenation_mean_flow":
                shifted = flat - flat.min(1, keepdim=True).values
                att = shifted / shifted.sum(1, keepdim=True)
            else:
                lo = flat.min(1, keepdim=True).values
                hi = flat.max(1, keepdim=True).values
                att = (flat - lo) / (hi - lo)
            sigm = att.reshape(psi_f.shape).to(x.dtype)
        sigm = resize_bilinear(sigm, tuple(x.shape[2:]), align_corners=True)
        y = sigm * x
        return (self.W(y) if self.W is not None else y), sigm
