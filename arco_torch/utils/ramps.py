"""Ramp schedules for consistency weights and temperatures (counterpart of
arco_tpu/utils/ramps.py; reference: code/utils/ramps.py).

Each function takes a Python number or a tensor and returns a 0-d (or
elementwise) f32 tensor, computed in f32 as the JAX versions compute it; a
zero ramp length returns the Python float 1.0, as there.
"""

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def sigmoid_rampup(current, rampup_length):
    """Exponential rampup from https://arxiv.org/abs/1610.02242
    (ramps.py:19)."""
    if rampup_length == 0:
        return 1.0
    phase = 1.0 - torch.clamp(_f32(current), 0.0, rampup_length) \
        / rampup_length
    return torch.exp(-5.0 * phase * phase)


def linear_rampup(current, rampup_length):
    """Linear rampup (ramps.py:29)."""
    if rampup_length == 0:
        return 1.0
    return torch.clamp(_f32(current), 0.0, rampup_length) / rampup_length


def cosine_rampdown(current, rampdown_length):
    """Cosine rampdown from https://arxiv.org/abs/1608.03983 (ramps.py:38)."""
    return 0.5 * (torch.cos(math.pi * _f32(current) / rampdown_length) + 1.0)


def exp_rampup(current, rampup_length):
    """Exponential rampup used by some mean-teacher variants (ramps.py:44)."""
    if rampup_length == 0:
        return 1.0
    current = _f32(current)
    ramp = torch.exp(-5.0 * (1.0 - torch.clamp(current, 0.0, rampup_length)
                             / rampup_length) ** 2)
    return torch.where(current < rampup_length, ramp, 1.0)


def cosine_temperature(epoch_num, max_epoch, t_low=0.1, t_high=1.0):
    """Cyclic temperature schedule (pretrain_2D.py:140-143)."""
    return (t_high - t_low) * (1 + torch.cos(
        2 * math.pi * _f32(epoch_num) / max_epoch)) / 2 + t_low
