"""Photometric augmentations (counterpart of arco_tpu/augment/photometric.py):
color jitter and gaussian blur, per sample, on NCHW batches.

Reference pipeline per sample (augment.py:168-180):
- 50%: ColorJitter(brightness=(0.75,1.25), contrast=(0.75,1.25),
       saturation=(0.75,1.25), hue=(-0.25,0.25)), in a fixed order;
       saturation and hue only act on 3-channel images;
- 50%: GaussianBlur(sigma ~ U[0.15, 1.15]).

The draws are explicit: ``draws`` holds one value per sample under
``p_jitter``, ``brightness``, ``contrast``, ``saturation``, ``hue``,
``p_blur`` and ``sigma`` (each [B]); missing ones come from ``generator``
with the JAX version's ranges. Every sample's jitter and blur are computed
and kept where its selection uniform is above 0.5, on the device, so the
host never waits on a drawn value.
"""

from __future__ import annotations

import math

import torch

from arco_torch.ops.gaussian import gaussian_blur_runtime_sigma

BRIGHTNESS = (0.75, 1.25)
CONTRAST = (0.75, 1.25)
SATURATION = (0.75, 1.25)
HUE = (-0.25, 0.25)
SIGMA = (0.15, 1.15)

_T_YIQ = ((0.299, 0.587, 0.114),
          (0.596, -0.274, -0.322),
          (0.211, -0.523, 0.312))


def draw_photometric(b: int, generator=None, device="cpu") -> dict:
    """The per-sample draws of one batch_photometric call."""
    u = lambda lo, hi: lo + torch.rand(b, generator=generator,
                                       device=device) * (hi - lo)
    return {"p_jitter": u(0.0, 1.0), "brightness": u(*BRIGHTNESS),
            "contrast": u(*CONTRAST), "saturation": u(*SATURATION),
            "hue": u(*HUE), "p_blur": u(0.0, 1.0), "sigma": u(*SIGMA)}


def _rgb_to_gray(x):
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


def _per_sample(v):
    return v.float().reshape(-1, 1, 1, 1)


def color_jitter(img, brightness, contrast, saturation=None, hue=None):
    """[B, C, H, W] images, C == 1 (medical) or 3; factors [B]. Contrast
    pulls toward each image's (gray) mean after the brightness factor."""
    x = img.float() * _per_sample(brightness)
    c = x.shape[1]
    gray_mean = (_rgb_to_gray(x) if c == 3 else x).mean(dim=(1, 2, 3),
                                                      keepdim=True)
    x = gray_mean + (x - gray_mean) * _per_sample(contrast)
    if c == 3:
        g = _rgb_to_gray(x)
        x = g + (x - g) * _per_sample(saturation)
        # hue rotation in YIQ space
        h = _per_sample(hue)[:, 0, 0, 0] * math.pi * 2
        cos_h, sin_h = torch.cos(h), torch.sin(h)
        zero, one = torch.zeros_like(h), torch.ones_like(h)
        rot = torch.stack([one, zero, zero,
                           zero, cos_h, -sin_h,
                           zero, sin_h, cos_h], dim=1).reshape(-1, 3, 3)
        t_yiq = torch.tensor(_T_YIQ, dtype=torch.float32)
        t_rgb = torch.linalg.inv(t_yiq)     # on the host: no error check
        x = torch.einsum("bchw,dc->bdhw", x, t_yiq.to(x.device))
        x = torch.einsum("bchw,bdc->bdhw", x, rot)
        x = torch.einsum("bchw,dc->bdhw", x, t_rgb.to(x.device))
    return x.clamp(0.0, 1.0).to(img.dtype)


def random_gaussian_blur(img, sigma):
    """Blur each image of [B, C, H, W] with its own sigma [B]."""
    return gaussian_blur_runtime_sigma(img, sigma).to(img.dtype)


def batch_photometric(images, draws=None, generator=None):
    """Per-sample random jitter, then blur, over a batch [B, C, H, W]
    (augment.py:168-180 inside batch_transform's sample loop)."""
    if draws is None:
        draws = draw_photometric(images.shape[0], generator, images.device)
    d = {k: v.to(images.device) for k, v in draws.items()}
    jittered = color_jitter(images, d["brightness"], d["contrast"],
                            d["saturation"], d["hue"])
    images = torch.where(_per_sample(d["p_jitter"]) > 0.5, jittered, images)
    blurred = random_gaussian_blur(images, d["sigma"])
    return torch.where(_per_sample(d["p_blur"]) > 0.5, blurred, images)
