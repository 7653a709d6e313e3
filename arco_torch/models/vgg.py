"""VGG feature extraction and DeepCluster's VGG-16 (counterpart of
arco_tpu/models/vgg.py), NCHW.

- ``VGG19Features`` (models/feature_extraction.py:87-220): named ReLU taps
  (``relu1_1`` .. ``relu5_4``) of a VGG-19 trunk, which stops once every
  requested tap is computed; optionally each tap L2-normalized over the
  channels (the norm in f32, + 1e-12).
- ``DeepClusterVGG16`` (models/deepcluster_vgg16.py): an optional fixed
  grayscale + Sobel stem (``sobel_stem``, constants in f32), a conv trunk
  with BatchNorm (flax momentum 0.9, eps 1e-5), the 4096-4096 MLP with
  dropout 0.5 after its first layer, and a ``top_layer`` unless
  ``include_top`` is False.

The names are torchvision's / the reference's (``features.{i}`` with the
ReLUs and pools counted, ``classifier.{0,3}``, ``top_layer``), so their
checkpoints load by name. The classifier flattens the trunk's map as torch
does, (c, h, w); JAX flattens (h, w, c), and compat/from_flax.py permutes
the first Linear's input to match. That Linear's width follows the input
size (``img_size``: 224 gives 512 * 7 * 7 = 25088).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import BatchNorm2d, DropoutDraws

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]


def _layer_names() -> List[str]:
    """VGG19_CFG's entries as named taps: relu{block}_{i} and pool{block}."""
    names = []
    block, idx = 1, 1
    for v in VGG19_CFG:
        if v == "M":
            names.append(f"pool{block}")
            block, idx = block + 1, 1
        else:
            names.append(f"relu{block}_{idx}")
            idx += 1
    return names


class VGG19Features(nn.Module):
    """Returns a dict of the requested taps. The trunk is built up to the
    deepest requested tap (all of it when none is), as flax creates only
    the convs its forward reaches."""

    def __init__(self, layers: Sequence[str] = ("relu3_2", "relu5_4"),
                 normalize_features: bool = False, in_chns: int = 3):
        super().__init__()
        self.layers = tuple(layers)
        self.normalize_features = normalize_features
        names = _layer_names()
        depth = max((names.index(n) + 1 for n in self.layers),
                    default=len(names))
        mods, cin = [], in_chns
        for v in VGG19_CFG[:depth]:
            if v == "M":
                mods.append(nn.MaxPool2d(2, 2))
            else:
                mods += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*mods)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        wanted = set(self.layers)
        out = {}
        mods = iter(self.features)
        h = x
        for name, v in zip(_layer_names(), VGG19_CFG):
            h = next(mods)(h)                 # the pool, or the conv
            if v != "M":
                h = next(mods)(h)             # its ReLU
            if name in wanted:
                f = h
                if self.normalize_features:
                    f = f / (torch.linalg.vector_norm(
                        f.float(), dim=1, keepdim=True) + 1e-12)
                out[name] = f
            if wanted and set(out) == wanted:
                break
        return out


def sobel_stem(x):
    """The reference's frozen grayscale (channel mean) and Sobel pair
    (deepcluster_vgg16.py:23-37), as constants in f32; cast back to x's
    dtype."""
    sx = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]],
                      device=x.device)
    kernel = torch.stack([sx, sx.T])[:, None]        # [2, 1, 3, 3]
    gray = x.mean(dim=1, keepdim=True).float()
    return F.conv2d(gray, kernel, padding=1).to(x.dtype)


class DeepClusterVGG16(nn.Module):
    """[sobel] -> conv trunk -> flatten -> Linear(512 * (H/32) * (W/32),
    4096), ReLU, Dropout(0.5), Linear(4096, 4096), ReLU -> [top_layer];
    ``img_size`` is an int or (H, W)."""

    def __init__(self, num_classes: int = 1000, sobel: bool = False,
                 batch_norm: bool = True, include_top: bool = True,
                 in_chns: int = 3, img_size: int = 224):
        super().__init__()
        self.sobel = sobel
        mods, cin = [], 2 if sobel else in_chns
        for v in VGG16_CFG:
            if v == "M":
                mods.append(nn.MaxPool2d(2, 2))
                continue
            mods.append(nn.Conv2d(cin, v, 3, padding=1))
            if batch_norm:
                mods.append(BatchNorm2d(v))
            mods.append(nn.ReLU())
            cin = v
        self.features = nn.Sequential(*mods)
        h, w = (img_size, img_size) if isinstance(img_size, int) \
            else tuple(img_size)
        self.classifier = nn.Sequential(
            nn.Linear(512 * (h // 32) * (w // 32), 4096), nn.ReLU(),
            nn.Dropout(0.5),
            nn.Linear(4096, 4096), nn.ReLU())
        self.top_layer = nn.Linear(4096, num_classes) if include_top \
            else None

    def forward(self, x, dropout_masks=None, generator=None):
        draws = DropoutDraws(dropout_masks, generator, self.training)
        if self.sobel:
            x = sobel_stem(x)
        h = torch.flatten(self.features(x), 1)
        for layer in self.classifier:
            h = draws.dropout(h, 0.5) if isinstance(layer, nn.Dropout) \
                else layer(h)
        return self.top_layer(h) if self.top_layer is not None else h
