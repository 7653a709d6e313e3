"""Adversarial diffeomorphic morphing, AdvMorph (counterpart of
arco_tpu/augment/morph.py).

A random velocity field on a coarse grid, L2 unit-normalized, scaled by
epsilon and gaussian-smoothed (sigma 1, 7 taps), is upsampled to the image
(align_corners=False) and integrated by scaling and squaring (8
self-compositions); the offsets are clipped, smoothed again and clipped, and
the images are warped with zeros padding (adv_morph.py:260-594). Like the
JAX version, the integral is the mathematically correct one: the
reference's in-place bias of the base grid (adv_morph.py:249-263) is not
replicated.

Images are NCHW. Flows, velocities and sampling grids are channels-last
[B, H, W, 2] in (x, y) order, the layout ``F.grid_sample`` takes its grid
in. The draws are explicit: ``velocity`` (uniforms in [-1, 1), [B, h_vec,
w_vec, 2]) and ``p`` (the one uniform that decides the whole batch).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from arco_torch.ops.gaussian import adv_morph_kernel_size, gaussian_blur_2d
from arco_torch.ops.interpolate import grid_sample_2d, resize_bilinear


def base_grid(batch_size: int, height: int, width: int,
              device="cpu") -> torch.Tensor:
    """Identity sampling grid [B, H, W, 2] in (x, y) order, linspace(-1, 1)
    (adv_morph.py:181-205)."""
    y = torch.linspace(-1.0, 1.0, height, device=device)
    x = torch.linspace(-1.0, 1.0, width, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([xx, yy], dim=-1)
    return grid.expand(batch_size, height, width, 2)


def unit_normalize(d: torch.Tensor) -> torch.Tensor:
    """Reference unit_normalize (adv_morph.py:120-146, p_type='l2'):
    d / max|d| per sample, then / ||d||_2 of the flattened field."""
    b = d.shape[0]
    shape = (b,) + (1,) * (d.ndim - 1)
    d = d / (d.reshape(b, -1).abs().amax(1).reshape(shape) + 1e-20)
    norm = torch.sqrt((d.reshape(b, -1) ** 2).sum(1)).reshape(shape)
    return d / (norm + 1e-16)


def _nchw(flow):
    return flow.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _compose(flow1: torch.Tensor, flow2: torch.Tensor) -> torch.Tensor:
    """applyComposition2D (adv_morph.py:297-307): sample flow1 at flow2's
    coordinates, border padding."""
    return _nhwc(grid_sample_2d(_nchw(flow1), flow2, mode="bilinear",
                                padding_mode="border", align_corners=True))


def field_exponentiation(duv: torch.Tensor,
                         nb_steps: int = 8) -> torch.Tensor:
    """Scaling-and-squaring integration of a velocity field [B, H, W, 2]
    -> offset field (vectorFieldExponentiation2D, adv_morph.py:266-294)."""
    b, h, w, _ = duv.shape
    grid = base_grid(b, h, w, duv.device)
    phi = grid + duv / (2.0 ** nb_steps)
    for _ in range(nb_steps):
        phi = _compose(phi, phi)
    return phi - grid


def _blur_flow(flow, sigma, ks):
    return _nhwc(gaussian_blur_2d(_nchw(flow), sigma, ks))


def _resize_flow(flow, size, align_corners):
    return _nhwc(resize_bilinear(_nchw(flow), size,
                                 align_corners=align_corners))


def draw_morph(batch_size: int, vector_size, generator=None,
               device="cpu") -> dict:
    """The draws of one adv_morph_batch call."""
    return {"p": torch.rand((), generator=generator, device=device),
            "velocity": torch.rand((batch_size, *vector_size, 2),
                                   generator=generator, device=device)
            * 2.0 - 1.0}


class AdvMorphParams(NamedTuple):
    velocity: torch.Tensor  # [B, h_vec, w_vec, 2]


class AdvMorph:
    """Functional AdvMorph: init_params -> deformation_grid -> transform.
    ``data_size`` is the images' NCHW shape (B, C, H, W)."""

    def __init__(self, data_size: Tuple[int, int, int, int],
                 vector_size: Tuple[int, int], epsilon: float = 1.5,
                 xi: float = 0.5, num_steps: int = 8, sigma: float = 1.0,
                 gaussian_ks: int = 3, coarse_exp: bool = True):
        self.batch, self.height, self.width = (data_size[0], data_size[2],
                                               data_size[3])
        self.vector_size = tuple(vector_size)
        self.epsilon = epsilon
        self.xi = xi
        self.num_steps = num_steps
        self.sigma = sigma
        self.ks = adv_morph_kernel_size(gaussian_ks, sigma)
        # integrate the band-limited field on a lattice of twice its native
        # resolution and upsample the offsets once (the JAX version's
        # coarse_exp); False integrates at the full image resolution
        self.coarse_exp = coarse_exp
        self.exp_size = (min(2 * self.vector_size[0], self.height),
                         min(2 * self.vector_size[1], self.width))

    def init_params(self, velocity: torch.Tensor) -> AdvMorphParams:
        """``velocity``: uniforms in [-1, 1) [B, h_vec, w_vec, 2]."""
        return AdvMorphParams(velocity=unit_normalize(velocity.float()))

    def deformation_grid(self, params: AdvMorphParams,
                         scale: float | None = None) -> torch.Tensor:
        """DemonsCompose (adv_morph.py:499-530) -> sampling grid [B,H,W,2].
        Sampling the identity grid at X with border padding is clip(X, -1,
        1), so the composition is a clip."""
        duv = params.velocity * (self.epsilon if scale is None else scale)
        duv = _blur_flow(duv, self.sigma, self.ks)
        # the full-size field is made even under coarse_exp, so that the
        # coarse lattice samples the align_corners=False signal the
        # reference integrates
        duv = _resize_flow(duv, (self.height, self.width), False)
        if self.coarse_exp:
            duv_c = _resize_flow(duv, self.exp_size, True)
            offsets = field_exponentiation(duv_c, self.num_steps)
            offsets = _resize_flow(offsets, (self.height, self.width), True)
        else:
            offsets = field_exponentiation(duv, self.num_steps)
        grid = base_grid(self.batch, self.height, self.width, duv.device)
        composed = torch.clamp(offsets + grid, -1.0, 1.0)
        smoothed = _blur_flow(composed - grid, self.sigma, self.ks)
        return torch.clamp(smoothed + grid, -1.0, 1.0)

    def transform(self, data: torch.Tensor, grid: torch.Tensor,
                  mode: str = "bilinear") -> torch.Tensor:
        """grid_sample with zeros padding, align_corners=True
        (adv_morph.py:558-573)."""
        return grid_sample_2d(data, grid, mode=mode, padding_mode="zeros",
                              align_corners=True)

    def forward(self, data: torch.Tensor,
                velocity: torch.Tensor) -> torch.Tensor:
        params = self.init_params(velocity)
        return self.transform(data, self.deformation_grid(params))

    def adversarial_step(self, params: AdvMorphParams, grad: torch.Tensor,
                         step_size: float) -> AdvMorphParams:
        """optimize_parameters (adv_morph.py:538-556): ascend the unit-
        normalized gradient of the attacked loss w.r.t. the velocity."""
        return AdvMorphParams(
            velocity=params.velocity + step_size * unit_normalize(grad))


def adv_morph_batch(images: torch.Tensor, p: float = 0.5,
                    epsilon: float = 1.5, coarse_exp: bool = True,
                    draws=None, generator=None) -> torch.Tensor:
    """Warp the whole batch [B, C, H, W] when its one uniform is above
    ``p`` (augment.py:271-279), with a velocity grid of (W // 8, W // 8)."""
    b, c, h, w = images.shape
    vector_size = (w // 8, w // 8)
    if draws is None:
        draws = draw_morph(b, vector_size, generator, images.device)
    morph = AdvMorph(data_size=(b, c, h, w), vector_size=vector_size,
                     epsilon=epsilon, coarse_exp=coarse_exp)
    warped = morph.forward(images, draws["velocity"].to(images.device))
    return torch.where(draws["p"].to(images.device) > p, warped, images)
