"""The natural-image branch's DeepLab models (counterpart of
arco_tpu/models/deeplab.py), NCHW.

Parity targets:
- models/deeplab.py:83-260 (DeepLab-v2): caffe-style ResNet (stride on the
  1x1 conv1 of each Bottleneck, maxpool 3x3/s2/p1 ceil_mode, layers 3/4
  dilated 2/4 at stride 1, every layer's first block downsampled) and the
  Classifier_Module summing four dilated 3x3 branches (6/12/18/24). The
  reference freezes every BatchNorm (train/freeze.py:apply_deeplab_bn_freeze).
- models/deeplabv3/deeplabv3.py:6-92 (DeepLabv3Plus): torchvision-style
  ResNet (stride on the 3x3 conv2) at dilate_scale 16, ASPP 6/12/18
  (aspp.py:42-66, project without dropout), low-level project 256 -> 48,
  twin classifier/representation heads on the 304-channel concat.
- models/deeplab_2branch.py:199-218 (DeepLab_2branch).

Parameter names are the reference's torch names: ``conv1``, ``bn1``,
``layer{1..4}.{b}.conv{1..3}`` / ``bn{1..3}`` / ``downsample.{0,1}`` and
``layer5.conv2d_list.{i}`` (what arco_tpu/compat/torch_import.py:250-310
maps), so a reference checkpoint loads by name. DeepLab-v3+ has no
importer in the JAX package; its trunk keeps the same names and its heads
the reference's module layout (``ASPP.convs.{0..4}``, ``ASPP.project``,
``project``, ``classifier``, ``representation``).

BatchNorms are models/layers.py:BatchNorm2d (flax's running-statistics
rule at flax momentum 0.9, eps 1e-5); the ASPP's pooled branch sees one
value per channel per image, which it normalizes to zero as flax does.

Forward contract of the ARCO models: ``model(x, dropout_masks=None,
generator=None)`` -> (logits, latent, [layer1..layer4 maps]), the maps
fine -> coarse. DeepLab2Branch returns its reference tuple.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import BatchNorm2d
from arco_torch.ops.interpolate import resize_bilinear


def max_pool_ceil(x, window: int = 3, stride: int = 2, pad: int = 1):
    """torch MaxPool(kernel, stride, padding, ceil_mode=True): output size
    ceil((H + 2p - k) / s) + 1, less one where the last window would start
    in the right padding (the rule JAX's version writes out), on an NCHW or
    NCDHW batch."""
    pool = {4: F.max_pool2d, 5: F.max_pool3d}[x.ndim]
    return pool(x, window, stride, pad, ceil_mode=True)


def _conv(cin, cout, k=1, stride=1, dilation=1, bias=False):
    pad = dilation * (k - 1) // 2
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad,
                     dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    """ResNet bottleneck. caffe=True puts the stride on conv1
    (deeplab.py:88, the caffe-converted DeepLab-v2 trunk); caffe=False on
    the 3x3 conv2 (torchvision, DeepLabv3Plus)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 caffe: bool = True):
        super().__init__()
        s1, s2 = (stride, 1) if caffe else (1, stride)
        self.conv1 = _conv(inplanes, planes, 1, stride=s1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride=s2, dilation=dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            _conv(inplanes, planes * 4, 1, stride=stride),
            BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class ResNetBackbone(nn.Module):
    """Dilated ResNet trunk, output stride 8 (caffe DeepLab-v2,
    deeplab.py:149-173) or 16 (torchvision flavor at dilate_scale=16,
    deeplabv3.py:9-17). ``trunk(x)`` returns the four stage outputs."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 caffe: bool = True, output_stride: int = 8,
                 in_chns: int = 3):
        super().__init__()
        self.caffe = caffe
        self.conv1 = nn.Conv2d(in_chns, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm2d(64)
        if output_stride == 8:
            specs = [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
        else:   # dilate_scale=16: layer3 keeps stride 2, layer4 dilated 2
            specs = [(64, 1, 1), (128, 2, 1), (256, 2, 1), (512, 1, 2)]
        inplanes = 64
        for li, ((planes, stride, dilation), blocks) in enumerate(
                zip(specs, layers), start=1):
            # the caffe trunk downsamples the first block of EVERY layer
            # (deeplab.py:175-180); torchvision does whenever the channels
            # change: the same blocks
            mods = [Bottleneck(inplanes, planes, stride, dilation,
                               downsample=True, caffe=caffe)]
            inplanes = planes * 4
            mods += [Bottleneck(inplanes, planes, 1, dilation, caffe=caffe)
                     for _ in range(blocks - 1)]
            setattr(self, f"layer{li}", nn.Sequential(*mods))

    def trunk(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        if self.caffe:
            h = max_pool_ceil(h)
        else:
            h = F.max_pool2d(h, 3, 2, 1)
        feats = []
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
            feats.append(h)
        return feats

    def forward(self, x):
        return self.trunk(x)

    def draw_dropout_masks(self, x_shape, generator=None, device=None):
        """No dropout anywhere: nothing to draw."""
        return None


class ClassifierModule(nn.Module):
    """DeepLab-v2 head: the SUM of dilated 3x3 conv branches
    (deeplab.py:130-146, dilations 6/12/18/24, bias=True)."""

    def __init__(self, inplanes: int, num_classes: int,
                 dilations: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            _conv(inplanes, num_classes, 3, dilation=d, bias=True)
            for d in dilations)

    def forward(self, x):
        out = self.conv2d_list[0](x)
        for conv in self.conv2d_list[1:]:
            out = out + conv(x)
        return out


def _conv_bn_relu(cin, cout, k=1, dilation=1):
    return nn.Sequential(_conv(cin, cout, k, dilation=dilation),
                         BatchNorm2d(cout), nn.ReLU())


class _ASPPPooling(nn.Sequential):
    """Global average pool, 1x1 conv, BatchNorm, ReLU, broadcast back (the
    align_corners=False upsample of a 1x1 map)."""

    def __init__(self, cin, cout):
        super().__init__(nn.AdaptiveAvgPool2d(1), _conv(cin, cout),
                         BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return super().forward(x).expand(-1, -1, *x.shape[2:])


class ASPP(nn.Module):
    """DeepLabv3Plus ASPP (models/deeplabv3/aspp.py:42-66): 1x1 + three
    dilated 3x3 + global pooling branch, 5 * 256 -> 256 project, no
    dropout (commented out in the reference)."""

    def __init__(self, in_channels: int = 2048,
                 atrous_rates: Sequence[int] = (6, 12, 18),
                 out_channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            [_conv_bn_relu(in_channels, out_channels)]
            + [_conv_bn_relu(in_channels, out_channels, 3, r)
               for r in atrous_rates]
            + [_ASPPPooling(in_channels, out_channels)])
        self.project = _conv_bn_relu(out_channels * (len(atrous_rates) + 2),
                                     out_channels)

    def forward(self, x):
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


class DeepLabV2(ResNetBackbone):
    """Caffe-trunk DeepLab-v2 in the ARCO model contract: forward ->
    (logits, latent, fmaps), latent the LAYER3 output (deeplab.py:205
    'feature = x' before layer5), fmaps the four stage outputs.
    ``upsample`` resizes the logits to the input size (align_corners
    False) for pixel-level training; the reference returns raw 1/8-res
    logits (deeplab.py:209)."""

    def __init__(self, num_classes: int = 21,
                 layers: Sequence[int] = (3, 4, 6, 3), upsample: bool = True,
                 in_chns: int = 3):
        super().__init__(layers, caffe=True, output_stride=8,
                         in_chns=in_chns)
        self.num_classes = num_classes
        self.upsample = upsample
        self.layer5 = ClassifierModule(2048, num_classes)

    def forward(self, x, dropout_masks=None, generator=None):
        feats = self.trunk(x)
        logits = self.layer5(feats[-1])
        if self.upsample:
            logits = resize_bilinear(logits, x.shape[2:],
                                     align_corners=False)
        return logits, feats[2], feats


class DeepLabV3Plus(ResNetBackbone):
    """DeepLabv3Plus (deeplabv3.py:6-92) in the ARCO model contract:
    torchvision trunk at dilate_scale=16, ASPP(6/12/18), low-level project
    256 -> 48, twin heads on the 304-channel concat. The reference returns
    (prediction, representation) at 1/4 resolution; here
    (logits[, upsampled], representation, [x_low, f2, f3, f4])."""

    def __init__(self, num_classes: int = 21,
                 layers: Sequence[int] = (3, 4, 6, 3),
                 output_dim: int = 256, upsample: bool = True,
                 in_chns: int = 3):
        super().__init__(layers, caffe=False, output_stride=16,
                         in_chns=in_chns)
        self.num_classes = num_classes
        self.upsample = upsample
        self.ASPP = ASPP(2048)
        self.project = _conv_bn_relu(256, 48)
        self.classifier = self._twin_head(num_classes)
        self.representation = self._twin_head(output_dim)

    @staticmethod
    def _twin_head(out_ch):
        return nn.Sequential(_conv(304, 256, 3), BatchNorm2d(256), nn.ReLU(),
                             _conv(256, out_ch, 1, bias=True))

    def forward(self, x, dropout_masks=None, generator=None):
        feats = self.trunk(x)
        x_low, f4 = feats[0], feats[-1]
        feature = self.ASPP(f4)
        proj = self.project(x_low)
        up = resize_bilinear(feature, x_low.shape[2:], align_corners=True)
        cat = torch.cat([proj, up], dim=1)
        logits = self.classifier(cat)
        representation = self.representation(cat)
        if self.upsample:
            logits = resize_bilinear(logits, x.shape[2:],
                                     align_corners=False)
        return logits, representation, feats


class DeepLab2Branch(ResNetBackbone):
    """The reference's DeepLab_2branch (models/deeplab_2branch.py:199-218):
    the v2 trunk, with layer4's 2048 channels split in two halves: the
    first returned raw as ``feature_instance``, the second L2-normalized
    per pixel as ``feature_part`` and fed to the v2 classifier (1024
    inputs, deeplab_2branch.py:132-148). Forward -> (feature_instance,
    feature_part, x5_logits, None) at 1/8 resolution, nothing upsampled."""

    def __init__(self, num_classes: int = 21,
                 layers: Sequence[int] = (3, 4, 23, 3), in_chns: int = 3):
        super().__init__(layers, caffe=True, output_stride=8,
                         in_chns=in_chns)
        self.num_classes = num_classes
        self.layer5 = ClassifierModule(1024, num_classes)

    def forward(self, x, dropout_masks=None, generator=None):
        x4 = self.trunk(x)[-1]
        c_n = x4.shape[1] // 2
        feature_instance, x4_second = x4[:, :c_n], x4[:, c_n:]
        x5 = self.layer5(x4_second)
        # torch F.normalize(dim=1): eps-clamped denominator
        norm = torch.sqrt(torch.sum(torch.square(x4_second), dim=1,
                                    keepdim=True))
        feature_part = x4_second / torch.clamp(norm, min=1e-12)
        return feature_instance, feature_part, x5, None


class DeepLab(DeepLabV2):
    """Back-compat alias of DeepLabV2 (as in the JAX package)."""


def _layers(backbone: str):
    return (3, 4, 23, 3) if "101" in backbone else (3, 4, 6, 3)


def model_generator(model: str = "deeplabv2", backbone: str = "resnet101",
                    num_classes: int = 21, **kw):
    """models/model_factory.py:19-61 dispatch: 'DeepLab' keys are v2 with
    the caffe trunk; 'deeplabv3' is DeepLabv3Plus; 'DeepLab_2branch' /
    'DeepLab50_2branch' the channel-split v2 (ResNet-101 unless the key or
    the backbone carries '50')."""
    name = model.lower()
    if "2branch" in name:
        layers = ((3, 4, 6, 3) if "50" in name or "50" in backbone
                  else (3, 4, 23, 3))
        return DeepLab2Branch(num_classes=num_classes, layers=layers, **kw)
    if "v3" in name:
        return DeepLabV3Plus(num_classes=num_classes,
                             layers=_layers(backbone), **kw)
    return DeepLabV2(num_classes=num_classes, layers=_layers(backbone), **kw)


def Res50_Deeplab(num_classes: int = 21) -> DeepLabV2:
    return DeepLabV2(num_classes=num_classes, layers=(3, 4, 6, 3))


def Res101_Deeplab(num_classes: int = 21) -> DeepLabV2:
    return DeepLabV2(num_classes=num_classes, layers=(3, 4, 23, 3))


def deeplab_feature_channels(model: str, backbone: str = "resnet101"):
    """Per-stage channel widths of the returned maps, for the ARCO
    FeatureExtractor (both trunks share the Bottleneck expansion)."""
    return (256, 512, 1024, 2048)
