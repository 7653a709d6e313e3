"""Swin-UNet: a shifted-window transformer encoder-decoder (counterpart of
arco_tpu/models/swin_unet.py; reference
networks/swin_transformer_unet_skip_expand_decoder_sys.py:599 and
networks/vision_transformer.py:24).

NCHW at the boundary, channels-last [B, H, W, C] inside, as the windows
are cut. A 4x4 patch embedding, encoder stages of Swin blocks with patch
merging, a symmetric decoder with patch expanding and the encoder stage
inputs as skips, a final 4x expand and a 1x1 head. The same options as
JAX: qkv_bias / qk_scale, drop_rate, drop_path_rate (linear over the
encoder blocks, mirrored by the decoder), ape, patch_norm, depths_decoder
(None: the decoder takes the encoder depths, the reference's effective
behaviour).

Each block pads its map to window multiples before the cyclic shift and
uses ``ws = min(window, h, w)``, with no shift when ``ws >= min(h, w)``.
``ws`` fixes the shape of the relative-position bias table, so the model
is built for one input size (``img_size``), as JAX's params are. Flax's
defaults kept: LayerNorm eps 1e-6 and the tanh GELU. Window attention is
``F.scaled_dot_product_attention`` with the bias table and the shift mask
(-100 between regions) as its additive mask.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from arco_torch.models.layers import DropoutDraws


def _pair(size):
    return (size, size) if isinstance(size, int) else tuple(size)


def _ln(dim):
    return nn.LayerNorm(dim, eps=1e-6)


def window_partition(x, ws: int):
    """[B, H, W, C] -> [B * nW, ws * ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """[nW, ws*ws, ws*ws]: -100 between positions of different regions of
    the rolled map, 0 within one."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    windows = window_partition(torch.from_numpy(img), ws).reshape(-1,
                                                                  ws * ws)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).float()


class WindowAttention(nn.Module):
    """Multi-head attention within each window, plus the relative-position
    bias; ``qkv`` and ``proj`` Linear layers."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale if qk_scale is not None \
            else (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        ws = window_size
        self.relative_position_bias_table = nn.Parameter(
            0.02 * torch.randn((2 * ws - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(ws).reshape(-1)), persistent=False)

    def forward(self, x, mask=None):
        bw, n, c = x.shape
        qkv = self.qkv(x).reshape(bw, n, 3, self.num_heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(n, n, -1).permute(2, 0, 1)
        bias = bias[None]                                  # [1, nh, n, n]
        if mask is not None:
            nw = mask.shape[0]
            bias = (bias + mask[:, None]).unsqueeze(0).expand(
                bw // nw, -1, -1, -1, -1).reshape(bw, -1, n, n)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(
            q.dtype), scale=self.scale)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> residual (drop path) -> LN ->
    MLP (tanh GELU) -> residual (drop path). Built for an [h, w] map."""

    def __init__(self, dim: int, num_heads: int, window_size: int, hw,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        h, w = hw
        self.hw = (h, w)
        self.ws = min(window_size, h, w)
        self.shift = shift if self.ws < min(h, w) else 0
        self.drop, self.drop_path = drop, drop_path
        self.norm1 = _ln(dim)
        self.attn = WindowAttention(dim, num_heads, self.ws, qkv_bias,
                                    qk_scale)
        self.norm2 = _ln(dim)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        if self.shift:
            hp, wp = -(-h // self.ws) * self.ws, -(-w // self.ws) * self.ws
            self.register_buffer("attn_mask", shift_mask(
                hp, wp, self.ws, self.shift), persistent=False)
        else:
            self.attn_mask = None

    def forward(self, x, draws: DropoutDraws):
        b, h, w, c = x.shape
        if (h, w) != self.hw:
            raise ValueError(f"SwinBlock built for {self.hw} maps, got "
                             f"{(h, w)}: build the model with this img_size")
        ws, shift = self.ws, self.shift
        shortcut = x
        x = self.norm1(x)
        # pad to window multiples BEFORE the cyclic shift (pad -> roll ->
        # partition), so that the mask's regions match the wrapped rows
        ph, pw = (-h) % ws, (-w) % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        attn = self.attn(window_partition(x, ws), self.attn_mask)
        attn = draws.dropout(attn, self.drop)
        x = window_reverse(attn, ws, hp, wp)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if ph or pw:
            x = x[:, :h, :w]
        x = shortcut + draws.drop_path(x, self.drop_path)
        y = F.gelu(self.fc1(self.norm2(x)), approximate="tanh")
        y = draws.dropout(self.fc2(draws.dropout(y, self.drop)), self.drop)
        return x + draws.drop_path(y, self.drop_path)


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in (row, col, channel) order, LN, a
    Linear 4C -> 2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = _ln(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class PatchExpand(nn.Module):
    """A Linear to ``scale``^2 x out channels without bias, the pixel
    shuffle, LN (``scale`` 2: out = dim // 2; 4: out = dim)."""

    def __init__(self, dim: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.out_c = dim // scale if scale == 2 else dim
        self.expand = nn.Linear(dim, self.out_c * scale ** 2, bias=False)
        self.norm = _ln(self.out_c)

    def forward(self, x):
        b, h, w, _ = x.shape
        s, c = self.scale, self.out_c
        x = self.expand(x).reshape(b, h, w, s, s, c).permute(0, 1, 3, 2, 4,
                                                             5)
        return self.norm(x.reshape(b, h * s, w * s, c))


class SwinUnet(nn.Module):
    """SwinTransformerSys; returns (logits, the normed bottleneck [B, 8C,
    H/32, W/32] for four stages, the encoder stage inputs as NCHW skips).
    ``dropout_masks``: the keep-masks in call order (DropoutDraws): with the
    defaults (drop_rate 0) the drop-path masks [B, 1, 1, 1] of every block
    with a positive rate, attention branch then MLP branch."""

    def __init__(self, img_size=224, num_classes: int = 4, in_chns: int = 1,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 2, 2),
                 depths_decoder: Optional[Sequence[int]] = None,
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, ape: bool = False,
                 patch_norm: bool = True):
        super().__init__()
        if attn_drop_rate:
            raise NotImplementedError(
                "attention-probability dropout: the reference config's "
                "rate is 0")
        self.num_classes = num_classes
        self.drop_rate = drop_rate
        n_stages = len(depths)
        self.latent_channels = embed_dim * 2 ** (n_stages - 1)
        size = tuple(s // 4 for s in _pair(img_size))
        self.patch_embed = nn.Conv2d(3 if in_chns == 1 else in_chns,
                                     embed_dim, 4, stride=4)
        self.patch_norm = _ln(embed_dim) if patch_norm else None
        self.absolute_pos_embed = nn.Parameter(
            0.02 * torch.randn(1, *size, embed_dim)) if ape else None

        total = sum(depths)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, total)] \
            if total > 1 else [0.0]
        stage_dpr = [dpr[sum(depths[:i]):sum(depths[:i + 1])]
                     for i in range(n_stages)]

        def blocks(dim, stage, depth, hw):
            rates = stage_dpr[stage]
            return nn.ModuleList(SwinBlock(
                dim, num_heads[stage], window_size, hw,
                shift=0 if blk % 2 == 0 else window_size // 2,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                drop=drop_rate, drop_path=rates[min(blk, len(rates) - 1)])
                for blk in range(depth))

        self.layers = nn.ModuleList()
        self.downsample = nn.ModuleList()
        dim, sizes = embed_dim, []
        for stage, depth in enumerate(depths):
            sizes.append(size)
            self.layers.append(blocks(dim, stage, depth, size))
            if stage < n_stages - 1:
                self.downsample.append(PatchMerging(dim))
                dim *= 2
                size = (size[0] // 2, size[1] // 2)
        self.norm = _ln(dim)

        self.layers_up = nn.ModuleList()
        self.upsample = nn.ModuleList()
        self.concat_back_dim = nn.ModuleList()
        for stage in range(n_stages - 2, -1, -1):
            self.upsample.append(PatchExpand(dim, 2))
            dim //= 2
            self.concat_back_dim.append(nn.Linear(2 * dim, dim))
            d = (depths_decoder[n_stages - 1 - stage]
                 if depths_decoder is not None else depths[stage])
            self.layers_up.append(blocks(dim, stage, d, sizes[stage]))
        self.norm_up = _ln(dim)
        self.up = PatchExpand(dim, 4)
        self.output = nn.Conv2d(dim, num_classes, 1, bias=False)

    def forward(self, x, dropout_masks=None, generator=None):
        draws = DropoutDraws(dropout_masks, generator, self.training)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        h = self.patch_embed(x).permute(0, 2, 3, 1)
        if self.patch_norm is not None:
            h = self.patch_norm(h)
        if self.absolute_pos_embed is not None:
            h = h + self.absolute_pos_embed.to(h.dtype)
        h = draws.dropout(h, self.drop_rate)

        skips = []
        for stage, layer in enumerate(self.layers):
            skips.append(h)
            for blk in layer:
                h = blk(h, draws)
            if stage < len(self.downsample):
                h = self.downsample[stage](h)
        h = latent = self.norm(h)

        for i, (expand, reduce, layer) in enumerate(zip(
                self.upsample, self.concat_back_dim, self.layers_up)):
            h = torch.cat([expand(h), skips[len(skips) - 2 - i]], dim=-1)
            h = reduce(h)
            for blk in layer:
                h = blk(h, draws)
        h = self.up(self.norm_up(h))
        nchw = lambda t: t.permute(0, 3, 1, 2)
        return (self.output(nchw(h)), nchw(latent),
                [nchw(s) for s in skips])
