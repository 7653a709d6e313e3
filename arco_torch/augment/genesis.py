"""ModelsGenesis-style intensity augmentations (counterpart of
arco_tpu/augment/genesis.py), on [..., H, W] tensors (NCHW batches or
single images).

Parity target: augment.py:30-130: the bezier nonlinear intensity remap,
local pixel shuffling, image in- and out-painting. They are vestigial in
the reference's main path (generate_unsup_data never calls them); they
complete the augmentation inventory. Each takes its draws as an explicit
argument (the JAX version's values, one per random quantity) or draws them
from ``generator``.
"""

from __future__ import annotations

from math import comb

import torch


def bezier_curve(points, n_times: int = 1000):
    """Bezier evaluation (augment.py:30-60) over control points [n, 2]:
    (xvals, yvals), each [n_times], t from 0 to 1."""
    points = torch.as_tensor(points, dtype=torch.float32)
    n = points.shape[0]
    t = torch.linspace(0.0, 1.0, n_times, device=points.device)
    basis = torch.stack([comb(n - 1, i) * t ** i * (1 - t) ** (n - 1 - i)
                         for i in range(n)])            # [n, T]
    return basis.t() @ points[:, 0], basis.t() @ points[:, 1]


def interp(x, xp, fp):
    """np.interp / jnp.interp: piecewise-linear through (xp, fp), constant
    beyond the ends, in jnp.interp's arithmetic."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # jnp.interp's guard against a zero-width interval
    dx0 = dx.abs() <= _spacing(torch.finfo(xp.dtype).eps, xp.dtype)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + delta / torch.where(dx0, 1.0, dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _spacing(v: float, dtype):
    """np.spacing(v) in ``dtype``: the gap to the next representable."""
    t = torch.tensor(v, dtype=dtype)
    return (torch.nextafter(t, torch.tensor(float("inf"), dtype=dtype))
            - t).item()


def draw_nonlinear(generator=None, device=None) -> dict:
    u = lambda *s: torch.rand(s, generator=generator, device=device)
    return {"points": u(4), "reverse": u() < 0.5, "apply": u()}


def nonlinear_transformation(x, prob: float = 0.9, draws=None,
                             generator=None):
    """Monotone bezier intensity remap (augment.py:88-100): control points
    (0, 0), p1, p2, (1, 1) with p1, p2 uniform (``draws["points"]`` [4]);
    ``draws["reverse"]`` mirrors the curve; applied when
    ``draws["apply"]`` < ``prob``."""
    if draws is None:
        draws = draw_nonlinear(generator, x.device)
    p = torch.as_tensor(draws["points"], dtype=torch.float32,
                        device=x.device)
    zero, one = torch.zeros(1, device=x.device), torch.ones(1,
                                                            device=x.device)
    points = torch.stack([torch.cat([zero, zero]), p[:2], p[2:],
                          torch.cat([one, one])])
    xvals, yvals = bezier_curve(points, n_times=1000)
    rev = torch.as_tensor(draws["reverse"], device=x.device)
    xs = torch.sort(torch.where(rev, 1.0 - xvals, xvals)).values
    ys = torch.where(rev, yvals.flip(0), yvals)
    out = interp(x.float().clamp(0.0, 1.0), xs, ys)
    apply = torch.as_tensor(draws["apply"], device=x.device) < prob
    return torch.where(apply, out, x.float()).to(x.dtype)


def _window(h, w, y0, x0, bh, bw, device):
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)


def draw_pixel_shuffling(h, w, num_block: int = 100, max_block: int = 8,
                         generator=None, device=None) -> dict:
    r = lambda lo, hi, *s: torch.randint(lo, hi, s, generator=generator,
                                         device=device)
    return {"size": r(2, max_block + 1, num_block, 2),
            "y0": r(0, h - max_block, num_block),
            "x0": r(0, w - max_block, num_block),
            "dy": r(1, max_block, num_block), "dx": r(1, max_block, num_block),
            "apply": torch.rand((), generator=generator, device=device)}


def local_pixel_shuffling(x, prob: float = 0.5, num_block: int = 100,
                          max_block: int = 8, draws=None, generator=None):
    """Shuffle pixels inside small random windows (augment.py:63-85), as
    the JAX version does: ``num_block`` times, the content rolled by (dy,
    dx) replaces a window of ``size`` at (y0, x0) (``draws``, one value a
    block); applied when ``draws["apply"]`` < ``prob``."""
    h, w = x.shape[-2], x.shape[-1]
    if draws is None:
        draws = draw_pixel_shuffling(h, w, num_block, max_block, generator,
                                     x.device)
    d = {k: torch.as_tensor(v) for k, v in draws.items()}
    out = x
    for i in range(num_block):
        rolled = torch.roll(out, (int(d["dy"][i]), int(d["dx"][i])),
                            dims=(-2, -1))
        inside = _window(h, w, int(d["y0"][i]), int(d["x0"][i]),
                         int(d["size"][i, 0]), int(d["size"][i, 1]),
                         x.device)
        out = torch.where(inside, rolled, out)
    return torch.where(d["apply"].to(x.device) < prob, out, x)


def image_in_painting(x, num_block: int = 5, block: int = 16, draws=None,
                      generator=None):
    """Replace ``num_block`` blocks of ``block`` x ``block`` at (y0, x0)
    with uniform noise (augment.py:103-116). ``draws``: "y0", "x0"
    [num_block] and "noise" [num_block, *x.shape]."""
    h, w = x.shape[-2], x.shape[-1]
    if draws is None:
        r = lambda hi: torch.randint(0, hi, (num_block,),
                                     generator=generator, device=x.device)
        draws = {"y0": r(max(h - block, 1)), "x0": r(max(w - block, 1)),
                 "noise": torch.rand((num_block,) + tuple(x.shape),
                                     generator=generator, device=x.device)}
    out = x
    for i in range(num_block):
        inside = _window(h, w, int(draws["y0"][i]), int(draws["x0"][i]),
                         block, block, x.device)
        out = torch.where(inside, draws["noise"][i].to(x.device, x.dtype),
                          out)
    return out


def image_out_painting(x, margin: int = 8, draws=None, generator=None):
    """Keep a random window of bh x bw at (y0, x0) and replace the rest
    with uniform noise (augment.py:119-130, whose torch version forgets to
    return). ``draws``: "bh", "bw", "y0", "x0" and "noise" [*x.shape]."""
    h, w = x.shape[-2], x.shape[-1]
    if draws is None:
        r = lambda lo, hi: int(torch.randint(lo, hi, (), generator=generator,
                                             device=x.device))
        bh, bw = r(h // 2, h - margin), r(w // 2, w - margin)
        draws = {"bh": bh, "bw": bw, "y0": r(0, h - bh + 1),
                 "x0": r(0, w - bw + 1),
                 "noise": torch.rand(x.shape, generator=generator,
                                     device=x.device)}
    inside = _window(h, w, int(draws["y0"]), int(draws["x0"]),
                     int(draws["bh"]), int(draws["bw"]), x.device)
    return torch.where(inside, x, draws["noise"].to(x.device, x.dtype))
