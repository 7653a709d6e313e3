"""The pix2pix/CycleGAN-era modules of networks/networks_other.py
(counterpart of arco_tpu/models/gan.py), NCHW: ``gan_loss`` (GANLoss
:260), ``ResnetGenerator`` (:301, with ``ResnetBlock`` :354), the
``UnetGenerator`` (:400-478) with its widths capped at ngf * 8,
``NLayerDiscriminator`` (:481), ``define_g`` / ``define_d`` (:143, :167)
and ``get_n_parameters`` (:196). ARCO's training path uses none of them.

The arithmetic is JAX's, where it departs from the reference:

- "batch" is flax's ``BatchNorm`` at its default momentum 0.99 (torch
  ``momentum=0.01``, with flax's biased running variance:
  layers.BatchNorm2d), "instance" flax's ``GroupNorm(group_size=1)`` with
  neither scale nor shift at eps 1e-6 (torch's InstanceNorm2d takes 1e-5);
- reflection padding before VALID convs;
- the transposed convs pad as flax's "SAME": (2, 1) around the dilated
  input for kernel 3 and stride 2 (the reference pads (1, 2)), (2, 2) for
  kernel 4, which ``SameConvTranspose2d`` reproduces.

``ResnetGenerator`` and ``NLayerDiscriminator`` keep the reference's
``model.{i}`` Sequential indices (the ResnetBlock's ``conv_block.{i}``);
the UnetGenerator, which the reference nests block in block, is the flat
stack of arco_tpu's (``down.{level}``, ``down_norm.{level}``,
``up.{level}``, ``up_norm.{level}``). Dropout masks can be passed in
(``dropout_masks``, in call order), else they are drawn from
``generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.init import jax_init_
from arco_torch.models.layers import BatchNorm2d, DropoutDraws, InstanceNorm


def norm_layer(norm_type: str, channels: int) -> nn.Module:
    """get_norm_layer (networks_other.py:78) as arco_tpu's ``_norm``."""
    if norm_type == "batch":
        return BatchNorm2d(channels, momentum=0.01)
    if norm_type == "instance":
        return InstanceNorm(eps=1e-6)
    if norm_type == "none":
        return nn.Identity()
    raise NotImplementedError(f"norm layer [{norm_type}] not found")


class SameConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d padded as flax's ``ConvTranspose(padding="SAME")``:
    the output is the input's size times the stride. lax pads the dilated
    input by (a, b) with b = k + s - 2 - a and a = k - 1 when s > k - 1,
    else ceil((k + s - 2) / 2); torch pads it by k - 1 - padding before
    and as much plus output_padding after, so a smaller b is cropped off
    the end."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 bias: bool = True):
        total = kernel + stride - 2
        before = kernel - 1 if stride > kernel - 1 else -(-total // 2)
        extra = total - 2 * before
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=kernel - 1 - before,
                         output_padding=max(extra, 0), bias=bias)
        self.crop = max(-extra, 0)

    def forward(self, x):
        y = super().forward(x)
        if self.crop:
            y = y[..., :y.shape[-2] - self.crop, :y.shape[-1] - self.crop]
        return y


def gan_loss(pred, target_is_real: bool, use_lsgan: bool = True,
             real_label: float = 1.0, fake_label: float = 0.0):
    """GANLoss (networks_other.py:260-296) as a function: LSGAN is the MSE
    against the label value, else BCE on probabilities clipped to
    [1e-7, 1 - 1e-7]."""
    target = torch.full_like(pred, real_label if target_is_real
                             else fake_label)
    if use_lsgan:
        return torch.mean((pred - target) ** 2)
    p = pred.clamp(1e-7, 1.0 - 1e-7)
    return -torch.mean(target * torch.log(p)
                       + (1.0 - target) * torch.log(1.0 - p))


class ResnetBlock(nn.Module):
    """Reflect-pad 3x3 conv + norm + ReLU (+ dropout 0.5), reflect-pad 3x3
    conv + norm, residual add (networks_other.py:354-397). The convs have
    a bias only under instance norm."""

    def __init__(self, dim: int, norm_type: str = "batch",
                 use_dropout: bool = False):
        super().__init__()
        bias = norm_type == "instance"
        layers = [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=bias),
                  norm_layer(norm_type, dim), nn.ReLU()]
        if use_dropout:
            layers.append(nn.Dropout(0.5))
        layers += [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=bias),
                   norm_layer(norm_type, dim)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x, draws: DropoutDraws):
        h = x
        for layer in self.conv_block:
            h = draws.dropout(h, 0.5) if isinstance(layer, nn.Dropout) \
                else layer(h)
        return x + h


class ResnetGenerator(nn.Module):
    """c7s1-ngf, two stride-2 downsamplings, ``n_blocks`` ResnetBlocks, two
    transposed-conv upsamplings, c7s1-out, tanh (networks_other.py:
    301-351)."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 n_blocks: int = 6, norm_type: str = "batch",
                 use_dropout: bool = False):
        super().__init__()
        bias = norm_type == "instance"
        layers = [nn.ReflectionPad2d(3),
                  nn.Conv2d(input_nc, ngf, 7, bias=bias),
                  norm_layer(norm_type, ngf), nn.ReLU()]
        for i in range(2):
            c = ngf * 2 ** i
            layers += [nn.Conv2d(c, 2 * c, 3, stride=2, padding=1,
                                 bias=bias),
                       norm_layer(norm_type, 2 * c), nn.ReLU()]
        layers += [ResnetBlock(ngf * 4, norm_type, use_dropout)
                   for _ in range(n_blocks)]
        for i in range(2):
            c = ngf * 2 ** (2 - i)
            layers += [SameConvTranspose2d(c, c // 2, 3, 2, bias=bias),
                       norm_layer(norm_type, c // 2), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x, dropout_masks=None, generator=None):
        draws = DropoutDraws(dropout_masks, generator, self.training)
        for layer in self.model:
            x = layer(x, draws) if isinstance(layer, ResnetBlock) \
                else layer(x)
        return x


class UnetGenerator(nn.Module):
    """The ``num_downs``-level U-Net generator (networks_other.py:400-478)
    as arco_tpu's explicit stack: 4x4 stride-2 down convs (conv alone at
    the outermost level, norm(conv(lrelu)) inside, conv(lrelu) innermost),
    up convs norm(convT(relu)) (tanh and a bias at the outermost), dropout
    0.5 after the up norm of levels 4 .. num_downs - 2, and each level's
    input concatenated before its up output ([skip, up])."""

    def __init__(self, input_nc: int, output_nc: int, num_downs: int = 7,
                 ngf: int = 64, norm_type: str = "batch",
                 use_dropout: bool = False):
        super().__init__()
        self.num_downs = num_downs
        self.use_dropout = use_dropout
        widths = [ngf * min(2 ** i, 8) for i in range(num_downs)]
        bias = norm_type == "instance"
        ins = [input_nc] + widths[:-1]
        self.down = nn.ModuleList(
            nn.Conv2d(ins[lv], widths[lv], 4, stride=2, padding=1, bias=bias)
            for lv in range(num_downs))
        self.down_norm = nn.ModuleDict(
            {str(lv): norm_layer(norm_type, widths[lv])
             for lv in range(1, num_downs - 1)})
        ups = {}
        for lv in range(num_downs):
            cin = widths[lv] if lv == num_downs - 1 else 2 * widths[lv]
            cout = output_nc if lv == 0 else widths[lv - 1]
            ups[str(lv)] = SameConvTranspose2d(cin, cout, 4, 2,
                                               bias=True if lv == 0 else bias)
        self.up = nn.ModuleDict(ups)
        self.up_norm = nn.ModuleDict(
            {str(lv): norm_layer(norm_type, widths[lv - 1])
             for lv in range(1, num_downs)})

    def forward(self, x, dropout_masks=None, generator=None):
        draws = DropoutDraws(dropout_masks, generator, self.training)
        skips = []
        h = x
        for lv in range(self.num_downs):
            skips.append(h)
            h = self.down[lv](h if lv == 0 else F.leaky_relu(h, 0.2))
            if str(lv) in self.down_norm:
                h = self.down_norm[str(lv)](h)
        for lv in reversed(range(self.num_downs)):
            h = self.up[str(lv)](F.relu(h))
            if lv == 0:
                return torch.tanh(h)
            h = self.up_norm[str(lv)](h)
            if self.use_dropout and 4 <= lv <= self.num_downs - 2:
                h = draws.dropout(h, 0.5)
            h = torch.cat([skips[lv], h], dim=1)


class NLayerDiscriminator(nn.Module):
    """PatchGAN (networks_other.py:481-529): ``n_layers`` 4x4 stride-2
    convs (widths ndf * 2^k capped at 8x), one stride-1, a 1-channel head,
    an optional sigmoid."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = "batch", use_sigmoid: bool = False):
        super().__init__()
        bias = norm_type == "instance"
        layers = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2)]
        prev = ndf
        for n in range(1, n_layers + 1):
            c = ndf * min(2 ** n, 8)
            layers += [nn.Conv2d(prev, c, 4, stride=2 if n < n_layers else 1,
                                 padding=1, bias=bias),
                       norm_layer(norm_type, c), nn.LeakyReLU(0.2)]
            prev = c
        layers.append(nn.Conv2d(prev, 1, 4, stride=1, padding=1))
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def define_g(input_nc: int, output_nc: int, ngf: int, which_model_netg: str,
             norm: str = "batch", use_dropout: bool = False) -> nn.Module:
    """networks_other.py:143-164 (torch needs ``input_nc``, which flax
    infers from the input); drawn as JAX draws it (``jax_init_``)."""
    kw = dict(norm_type=norm, use_dropout=use_dropout)
    if which_model_netg == "resnet_9blocks":
        net = ResnetGenerator(input_nc, output_nc, ngf, n_blocks=9, **kw)
    elif which_model_netg == "resnet_6blocks":
        net = ResnetGenerator(input_nc, output_nc, ngf, n_blocks=6, **kw)
    elif which_model_netg == "unet_128":
        net = UnetGenerator(input_nc, output_nc, 7, ngf, **kw)
    elif which_model_netg == "unet_256":
        net = UnetGenerator(input_nc, output_nc, 8, ngf, **kw)
    else:
        raise NotImplementedError(
            f"Generator model name [{which_model_netg}] is not recognized")
    return jax_init_(net)


def define_d(input_nc: int, ndf: int, which_model_netd: str,
             n_layers_d: int = 3, norm: str = "batch",
             use_sigmoid: bool = False) -> nn.Module:
    """networks_other.py:167-185; drawn as JAX draws it (``jax_init_``)."""
    if which_model_netd not in ("basic", "n_layers"):
        raise NotImplementedError(f"Discriminator model name "
                                  f"[{which_model_netd}] is not recognized")
    n_layers = 3 if which_model_netd == "basic" else n_layers_d
    return jax_init_(NLayerDiscriminator(input_nc, ndf, n_layers, norm,
                                         use_sigmoid))


def get_n_parameters(model: nn.Module) -> int:
    """networks_other.py:196-200."""
    return sum(p.numel() for p in model.parameters())
