"""Shared building blocks (counterpart of arco_tpu/models/layers.py), NCHW.

Module and parameter names follow the reference PyTorch U-Net
(networks/unetWithArgs.py): ``conv_conv.{0 conv, 1 bn, 4 conv, 5 bn}``, so
reference checkpoints load by name.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.ops.interpolate import resize_bilinear
from arco_torch.ops.collectives import all_reduce_sum


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.01)


class _FlaxBatchNorm:
    """BatchNorm with flax's running-statistics rule, for any rank.

    flax ``BatchNorm(momentum=0.9)`` is torch ``momentum=0.1``, eps 1e-5.
    flax also updates the running variance with the BIASED batch variance,
    where torch's own BatchNorm uses the unbiased one (n/(n-1) larger: 8/7
    at the 2x2 bottleneck of a 32² batch of 2), so the running update is
    done here by hand, over every dim but the channels. Normalization
    itself uses the batch statistics, as both frameworks do in train
    mode. flax's default momentum 0.99 is ``momentum=0.01`` here.

    ``stats_group`` (set inside ``sync_batch_norm``): a process group over
    whose ranks' whole batch the train-mode statistics are taken; None
    takes this process's batch."""

    stats_group = None

    def __init__(self, num_features: int, affine: bool = True,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=1e-5, momentum=momentum,
                         affine=affine)
        # off while a checkpointed forward is recomputed (running_stats_
        # frozen): the statistics move once per forward, as in JAX
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = (0,) + tuple(range(2, x.ndim))
        if self.stats_group is not None:
            # the group's whole batch: the mean (one all-reduce of the
            # per-channel sums and the element count), then the biased
            # variance around it, each summed over every rank through a
            # differentiable all-reduce (two passes, as one process
            # computes them over the whole batch)
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            sums = all_reduce_sum(torch.cat([xf.sum(dims), xf.new_full(
                (1,), x.numel() / x.shape[1])]), self.stats_group)
            mean, count = sums[:-1] / sums[-1], sums[-1]
            d = xf - mean.view(_channel_shape(x))
            var = all_reduce_sum((d * d).sum(dims), self.stats_group) / count
            if self.update_stats:
                self._update_running(mean, var)
            return self._normalize(xf, mean, var).to(x.dtype)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=dims,
                                           correction=0)
            self._update_running(mean, var)
        if x.numel() == x.shape[1]:
            # one value per channel (the DeepLab-v3+ ASPP's pooled branch at
            # batch 1): torch's batch_norm refuses it, flax normalizes it to
            # zero; the same formula here, so the gradient is flax's too
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(xf, dim=dims, correction=0)
            return self._normalize(xf, mean, var).to(x.dtype)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    @torch.no_grad()
    def _update_running(self, mean, var):
        self.running_mean.mul_(1 - self.momentum).add_(
            mean, alpha=self.momentum)
        self.running_var.mul_(1 - self.momentum).add_(
            var, alpha=self.momentum)

    def _normalize(self, xf, mean, var):
        """(xf - mean) / sqrt(var + eps), then the affine map; mean and
        var per channel."""
        shape = _channel_shape(xf)
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y


def _channel_shape(x):
    """The shape that broadcasts a per-channel vector over x [B, C, ...]."""
    return (1, -1) + (1,) * (x.ndim - 2)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


class InstanceNorm(nn.Module):
    """torch InstanceNorm's defaults: no affine parameters, no running
    statistics, ``eps`` (1e-5) on the biased variance. The statistics are
    at least f32 whatever autocast is on (a float64 input keeps float64),
    and the result is cast back to the input's dtype, as JAX computes it;
    a map of one voxel normalizes to 0 (where ``F.instance_norm`` refuses
    it)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def normalize(self, x):
        """The normalized map in the statistics' dtype."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(xf, dim=tuple(range(2, x.ndim)),
                                   correction=0, keepdim=True)
        return (xf - mean) / torch.sqrt(var + self.eps)

    def forward(self, x):
        return self.normalize(x).to(x.dtype)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Train-mode forwards of ``module`` inside the block normalize with the
    batch statistics as usual but leave the running statistics alone."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


@contextlib.contextmanager
def sync_batch_norm(module: nn.Module, group):
    """Train-mode forwards of ``module`` inside the block take every
    BatchNorm's statistics over the whole batch of ``group``'s ranks, as one
    process over that batch takes them (JAX's global batch statistics under
    data sharding); ``group=None`` leaves them per process."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxBatchNorm)]
    for m in bns:
        m.stats_group = group
    try:
        yield
    finally:
        for m in bns:
            m.stats_group = None


def dropout(x, p: float, mask=None, generator=None, training: bool = True):
    """Inverted dropout with an explicit keep-``mask`` (bool, x's shape) or
    one drawn from ``generator``: x * keep / (1 - p), as flax Dropout."""
    if not training or p == 0.0:
        return x
    if mask is None:
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < (1.0 - p)
    return torch.where(mask, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class DropoutDraws:
    """The keep-masks of one forward, handed out in call order.

    A model with several dropout sites takes ``masks`` (a list in the
    order its flax counterpart draws them: only sites with a positive rate
    in a train-mode forward draw) and ``generator``; each site asks for the
    next mask, and a missing or None entry is drawn from ``generator``."""

    def __init__(self, masks=None, generator=None, training: bool = True):
        self.masks = list(masks or [])
        self.generator = generator
        self.training = training
        self.i = 0

    def _next(self):
        m = self.masks[self.i] if self.i < len(self.masks) else None
        self.i += 1
        return m

    def dropout(self, x, p: float):
        if not self.training or p == 0.0:
            return x
        return dropout(x, p, self._next(), self.generator)

    def drop_path(self, x, rate: float):
        """Stochastic depth: the whole sample's branch kept (x / keep) or
        dropped, as timm's drop_path."""
        if not self.training or rate == 0.0:
            return x
        mask = self._next()
        if mask is None:
            mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                              generator=self.generator,
                              device=x.device) < (1.0 - rate)
        return dropout(x, rate, mask)


def same_pad(x, kernel, stride=1, dilation=1, value=0.0):
    """Pad the spatial dims of [B, C, *spatial] ``x`` as flax/TF "SAME"
    does before a strided window: the total padding max((out - 1) * s +
    (k - 1) * d + 1 - n, 0) with out = ceil(n / s), its smaller half
    before. With stride 2 and an even size this is asymmetric ((0, 1) for
    k = 3, (1, 2) for k = 5, (2, 3) for k = 7), which ``padding=k // 2``
    is not."""
    nd = x.ndim - 2
    ks = (kernel,) * nd if isinstance(kernel, int) else tuple(kernel)
    pads = []
    for n, k in zip(reversed(x.shape[2:]), reversed(ks)):
        out = -(-n // stride)
        total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


class SameConv2d(nn.Conv2d):
    """Conv2d with flax's "SAME" padding for any stride (``same_pad``)."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, dilation=1,
                 groups=1, bias=True):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         dilation=dilation, groups=groups, bias=bias)

    def forward(self, x):
        return super().forward(same_pad(x, self.kernel_size, self.stride[0],
                                        self.dilation[0]))


class MLP2(nn.Sequential):
    """Two stacked Linear layers (latent predictor, model_2D.py:146-151;
    counterpart of arco_tpu/models/layers.py:MLP2)."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__(nn.Linear(in_features, hidden),
                         nn.Linear(hidden, out))


class FeaturePerturbation:
    """The feature perturbations of UNet_CCT's aux decoders and UNet_URPC
    (unetWithArgs.py:277-307), on NCHW maps. Each takes its draw as an
    argument (the layout of ``x``, or [B] for ``feature_dropout``), drawn
    from ``generator`` when it is None."""

    @staticmethod
    def dropout(x, p: float = 0.3, keep=None, generator=None):
        if keep is None:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) < (1.0 - p)
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    @staticmethod
    def feature_dropout(x, low: float = 0.7, high: float = 0.9, u=None,
                        generator=None):
        """Zero the positions whose channel mean reaches ``u`` (drawn in
        [low, high)) times the sample's largest channel mean."""
        if u is None:
            u = low + (high - low) * torch.rand(
                (x.shape[0],), generator=generator, device=x.device)
        attention = x.mean(dim=1, keepdim=True)
        max_val = attention.reshape(x.shape[0], -1).amax(dim=1)
        thresh = (max_val * u.to(max_val.dtype)).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        return torch.where(attention < thresh, x, torch.zeros_like(x))

    @staticmethod
    def feature_noise(x, uniform_range: float = 0.3, noise=None,
                      generator=None):
        if noise is None:
            noise = (torch.rand(x.shape, generator=generator,
                                device=x.device) * 2 - 1) * uniform_range
        return x * noise.to(x.dtype) + x


CONV = {2: nn.Conv2d, 3: nn.Conv3d}          # by spatial rank
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_BN = {2: BatchNorm2d, 3: BatchNorm3d}


class ConvBNAct(nn.Module):
    """Conv 3^nd (same) -> BatchNorm -> LeakyReLU(0.01) or ReLU, over
    ``nd`` spatial dims."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, nd: int = 2,
                 act: str = "leaky_relu"):
        super().__init__()
        if act not in ("leaky_relu", "relu"):
            raise ValueError(act)
        self.conv = CONV[nd](in_ch, out_ch, kernel, padding=kernel // 2)
        self.bn = _BN[nd](out_ch)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return leaky_relu(x) if self.act == "leaky_relu" else F.relu(x)


def ConvTransposeUp(in_ch: int, out_ch: int, nd: int = 3):
    """Transposed conv, kernel 2 and stride 2, over ``nd`` spatial dims
    (counterpart of arco_tpu/models/layers.py:ConvTransposeUp; torch's
    weight is flax's kernel flipped, see compat/from_flax.py)."""
    return _CONV_T[nd](in_ch, out_ch, 2, stride=2)


class ConvBlock2D(nn.Module):
    """Two (Conv3x3 + BN + LeakyReLU) with dropout after the first
    activation (unetWithArgs.py:31-47)."""

    def __init__(self, in_ch: int, out_ch: int, dropout_p: float):
        super().__init__()
        self.dropout_p = float(dropout_p)
        self.conv_conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1), BatchNorm2d(out_ch),
            nn.LeakyReLU(0.01), nn.Dropout(self.dropout_p),
            nn.Conv2d(out_ch, out_ch, 3, padding=1), BatchNorm2d(out_ch),
            nn.LeakyReLU(0.01))

    def forward(self, x, mask=None, generator=None):
        c = self.conv_conv
        x = leaky_relu(c[1](c[0](x)))
        x = dropout(x, self.dropout_p, mask, generator, self.training)
        return leaky_relu(c[5](c[4](x)))


def max_pool(x, window: int = 2):
    return F.max_pool2d(x, window, window)


class BilinearUp(nn.Module):
    """1x1 conv + 2x bilinear upsample (align_corners=True): the path the
    reference UpBlock actually takes (see arco_tpu/models/layers.py)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        x = self.conv1x1(x)
        return resize_bilinear(x, tuple(2 * s for s in x.shape[2:]),
                               align_corners=True)


def adaptive_avg_pool(x, out_size: int):
    """torch AdaptiveAvgPool over the 2 or 3 spatial dims of [B, C,
    *spatial] ``x`` (counterpart of arco_tpu/models/layers.py:
    adaptive_avg_pool, which is channels-last): output cell i averages
    input rows floor(i*n/o) .. ceil((i+1)*n/o), so sizes that do not divide
    are covered too."""
    pool = {4: F.adaptive_avg_pool2d, 5: F.adaptive_avg_pool3d}[x.ndim]
    return pool(x, out_size)
