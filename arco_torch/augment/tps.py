"""Thin-plate-spline random warps (counterpart of arco_tpu/augment/tps.py).

``TPSGridGen`` is the same deterministic numpy solve as the JAX version
(a copy, not an import). ``RandTPS.reset`` takes its draws explicitly: the
control-point perturbation [B, 25, 2], the similarity transform's angle in
degrees, scale, tx and ty [B] each, and one mirror flag for the batch;
missing draws come from ``generator`` with the JAX version's ranges.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from arco_torch.ops.interpolate import grid_sample_2d


def _partial_repr(points_a: np.ndarray, points_b: np.ndarray) -> np.ndarray:
    """phi(r) = 0.5 * r^2 * log(r^2) radial basis (tps_grid_gen.py:9-21)."""
    diff = points_a[:, None, :] - points_b[None, :, :]
    dist2 = (diff ** 2).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rep = 0.5 * dist2 * np.log(dist2)
    return np.nan_to_num(rep, nan=0.0, posinf=0.0, neginf=0.0)


class TPSGridGen:
    """Precomputed TPS solve for a fixed target grid; ``__call__`` maps
    batched source control points [B, N, 2] to a sampling grid
    [B, H, W, 2] (torch grid_sample convention) with two matmuls."""

    def __init__(self, target_height: int, target_width: int,
                 target_control_points: np.ndarray):
        n = target_control_points.shape[0]
        self.num_points = n
        tcp = np.asarray(target_control_points, np.float32)

        forward_kernel = np.zeros((n + 3, n + 3), np.float32)
        forward_kernel[:n, :n] = _partial_repr(tcp, tcp)
        forward_kernel[:n, -3] = 1.0
        forward_kernel[-3, :n] = 1.0
        forward_kernel[:n, -2:] = tcp
        forward_kernel[-2:, :n] = tcp.T
        inverse_kernel = np.linalg.inv(forward_kernel)

        hw = target_height * target_width
        yx = np.array(list(itertools.product(range(target_height),
                                             range(target_width))), np.float32)
        y = yx[:, 0:1] * 2 / (target_height - 1) - 1
        x = yx[:, 1:2] * 2 / (target_width - 1) - 1
        target_coordinate = np.concatenate([x, y], axis=1)  # (x, y) order
        repr_mat = np.concatenate([
            _partial_repr(target_coordinate, tcp), np.ones((hw, 1), np.float32),
            target_coordinate], axis=1)

        self.inverse_kernel = torch.from_numpy(
            np.asarray(inverse_kernel, np.float32))
        self.target_coordinate_repr = torch.from_numpy(
            np.asarray(repr_mat, np.float32))
        self.target_control_points = torch.from_numpy(tcp)
        self.target_height = target_height
        self.target_width = target_width
        self._on_device = {}

    def constants(self, device) -> tuple:
        """(inverse kernel, target coordinate repr, target control points)
        on ``device``, copied there once: a host-to-device copy each step
        would make the host wait for the device."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = tuple(
                t.to(device) for t in (self.inverse_kernel,
                                       self.target_coordinate_repr,
                                       self.target_control_points))
        return self._on_device[device]

    def __call__(self, source_control_points: torch.Tensor) -> torch.Tensor:
        b = source_control_points.shape[0]
        dev = source_control_points.device
        inverse_kernel, repr_mat, _ = self.constants(dev)
        pad = torch.zeros((b, 3, 2), dtype=torch.float32, device=dev)
        y = torch.cat([source_control_points.float(), pad], dim=1)
        mapping = inverse_kernel @ y
        coords = repr_mat @ mapping
        return coords.reshape(b, self.target_height, self.target_width, 2)


def default_control_points() -> np.ndarray:
    """5x5 grid over [-1,1]^2 in itertools.product order."""
    axis = np.arange(-1.0, 1.00001, 2.0 / 4)
    return np.array(list(itertools.product(axis, axis)), np.float32)


def draw_tps(batch_size: int, sigma: float = 0.01, translate: float = 0.1,
             random_scale=(0.8, 1.2), rotate: float = 60.0, generator=None,
             device="cpu") -> dict:
    """The draws of one RandTPS.reset (rand_tps.py:52-79,110-148); the
    scale range is inverted because the warp maps target -> source."""
    u = lambda *shape: torch.rand(shape, generator=generator, device=device)
    lo, hi = 1.0 / random_scale[1], 1.0 / random_scale[0]
    return {"pert": (u(batch_size, 25, 2) * 2 - 1) * sigma,
            "angle": (u(batch_size) * 2 - 1) * rotate,
            "scale": lo + u(batch_size) * (hi - lo),
            "tx": (u(batch_size) * 2 - 1) * translate,
            "ty": (u(batch_size) * 2 - 1) * translate,
            "flip": u(1)[0] < 0.5}


def make_rand_tps_grid(draws: dict, gridgen: TPSGridGen,
                       random_mirror: bool = True, mode: str = "affine"):
    """One random TPS sampling grid [B, H, W, 2] from explicit draws."""
    pert = draws["pert"].float()
    dev = pert.device
    scp = gridgen.constants(dev)[2][None] + pert
    if mode == "affine":
        angle = draws["angle"].float().to(dev) / 180.0 * math.pi
        scale = draws["scale"].float().to(dev)
        img_sz = 2.0
        cos_v, sin_v = scale * torch.cos(angle), scale * torch.sin(angle)
        theta = torch.stack([cos_v, -sin_v,
                             draws["tx"].float().to(dev) * img_sz / 2.0,
                             sin_v, cos_v,
                             draws["ty"].float().to(dev) * img_sz / 2.0],
                            dim=1).reshape(-1, 2, 3)
        ones = torch.ones((*scp.shape[:2], 1), dtype=scp.dtype, device=dev)
        scp = torch.cat([scp, ones], dim=2) @ theta.transpose(1, 2)
    if random_mirror:
        flip = torch.as_tensor(draws["flip"], device=dev)
        scp = torch.cat([torch.where(flip, -scp[..., :1], scp[..., :1]),
                         scp[..., 1:]], dim=-1)
    return gridgen(scp)


class RandTPS:
    """Random TPS warps: ``grid = tps.reset(draws)``; ``tps.apply(x, grid)``
    on NCHW images, or on NCDHW volumes [B, C, H, W, D], where the same 2D
    grid warps every depth slice (rand_tps_3d.py:147-167)."""

    def __init__(self, width: int, height: int, batch_size: int,
                 sigma: float = 0.01, border_padding: bool = False,
                 random_mirror: bool = True, random_scale=(0.8, 1.2),
                 mode: str = "affine"):
        self.gridgen = TPSGridGen(height, width, default_control_points())
        self.batch_size = batch_size
        self.sigma = sigma
        self.padding_mode = "border" if border_padding else "zeros"
        self.random_mirror = random_mirror
        self.random_scale = random_scale
        self.mode = mode

    def reset(self, draws: dict | None = None, generator=None,
              device="cpu") -> torch.Tensor:
        if draws is None:
            draws = draw_tps(self.batch_size, self.sigma,
                             random_scale=self.random_scale,
                             generator=generator, device=device)
        return make_rand_tps_grid(draws, self.gridgen, self.random_mirror,
                                  self.mode)

    def apply(self, x: torch.Tensor, grid: torch.Tensor,
              padding_mode: str | None = None, mode: str = "bilinear"):
        sample = lambda t: grid_sample_2d(
            t, grid, mode=mode, padding_mode=padding_mode or self.padding_mode,
            align_corners=True)
        if x.ndim == 4:
            return sample(x)
        # 3D: depth folded into the channels, one 2D gather for all slices
        # (the z coordinate is the identity), as the JAX version does
        b, c, h, w, d = x.shape
        out = sample(x.permute(0, 1, 4, 2, 3).reshape(b, c * d, h, w))
        return out.reshape(b, c, d, *out.shape[2:]).permute(0, 1, 3, 4, 2)
