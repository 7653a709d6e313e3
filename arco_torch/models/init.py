"""The JAX package's initial weights for the port's modules.

Every ``arco_tpu/models`` module draws flax's defaults: ``lecun_normal``
kernels for ``nn.Conv``, ``nn.ConvTranspose``, ``nn.Dense`` and the
attention projections, with zero biases. ``jax_init_`` redraws a built
module tree the same way; the factories and the head builders call it, so
every entry point starts from JAX's distributions rather than torch's
``kaiming_uniform_(a=sqrt(5))``. A module built from its class directly
(the discriminators and VGGs, which no factory builds) keeps torch's draw
unless its caller passes it here.

What a JAX module sets explicitly is left as the port's constructors set
it: norms at ones / zeros, ENet's PReLU slope at 0.25, the ``normal(0.02)``
tables of Swin-UNet and ViT_Seg, and a conv bias that carries a
``jax_bias`` value (the 3-D attention gates' psi bias, ``unet3d.py``).

flax's fan-in is the product of every kernel axis but the output one:
``k * in / groups`` for a conv (torch's ``weight[0]``), ``k * in`` for a
transposed conv (torch stores it ``[in, out / groups, *k]``), ``in`` for a
dense layer, and for the attention projections the dense layer's input
width (hidden for query / key / value, heads x head_dim for the output).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

# the std of a unit normal truncated at +-2: flax divides the draw by it
TRUNC_STD = 0.87962566103423978

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_CONVS_T = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)
KERNEL_LAYERS = _CONVS + _CONVS_T + (nn.Linear,)


def fan_in(layer: nn.Module) -> int:
    """flax's fan-in of ``layer``'s kernel (see the module docstring)."""
    w = layer.weight
    if isinstance(layer, _CONVS_T):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


@torch.no_grad()
def jax_init_(module: nn.Module, generator: torch.Generator = None):
    """Redraw every conv, transposed-conv and linear layer of ``module`` as
    flax's ``lecun_normal`` (a unit normal truncated at +-2, divided by
    ``TRUNC_STD``, times 1 / sqrt(fan-in)) with the bias at zero, or at the
    layer's ``jax_bias``. Draws from ``generator``, else from torch's global
    generator, layer by layer in ``module.modules()`` order. Returns
    ``module``."""
    for layer in module.modules():
        if not isinstance(layer, KERNEL_LAYERS):
            continue
        w = layer.weight
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(1.0 / (TRUNC_STD * math.sqrt(fan_in(layer))))
        if layer.bias is not None:
            layer.bias.fill_(getattr(layer, "jax_bias", 0.0))
    return module
