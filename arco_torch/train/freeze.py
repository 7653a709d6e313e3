"""Encoder/decoder freeze surface of the pretrain (``--train_encoder`` /
``--train_decoder``; counterpart of arco_tpu/train/freeze.py).

Reference: pretrain_2D.py:71-72 / pretrain_3D.py:73-74 expose the flags,
unetWithArgs.py:326-343 sets ``requires_grad=False`` on the frozen half of
the U-Net (model_3D.py:103-106 of the V-Net), and the
snapshot directory gets a ``_train_encoder`` / ``_train_decoder`` suffix
in place of ``final`` (pretrain_2D.py:313-320). In torch idiom the frozen
half's parameters get ``requires_grad_(False)`` and stay out of the
optimizer, so a step leaves them bit-identical: no gradient, no weight
decay, no momentum (JAX routes them to ``optax.set_to_zero``).
``apply_deeplab_bn_freeze`` does the same to the BatchNorm scales and
biases of DeepLab-v2.
"""

from __future__ import annotations

import torch


def snapshot_suffix(train_encoder: bool = True,
                    train_decoder: bool = True) -> str:
    """Snapshot-dir suffix of the freeze configuration
    (pretrain_2D.py:313-320). Both frozen crashes the reference (its
    ``suffix`` is never assigned); this returns an explicit marker."""
    if train_encoder and train_decoder:
        return "final"
    if train_encoder:
        return "_train_encoder"
    if train_decoder:
        return "_train_decoder"
    return "_frozen"


# the V-Net's encoder (vnetWithArgs.py:180-201): the first five conv
# blocks and the four downsamplings; every other top-level module (the
# upsamplings, block_six..block_nine, out_conv) is its decoder
_VNET_ENCODER = tuple(f"block_{n}" for n in ("one", "two", "three", "four",
                                               "five")) \
    + tuple(f"block_{n}_dw" for n in ("one", "two", "three", "four"))
_VNET_DECODER = ("block_five_up", "block_six_up", "block_seven_up",
                 "block_eight_up", "block_six", "block_seven", "block_eight",
                 "block_nine", "out_conv")


def _part_of(name: str) -> str:
    """Classify a parameter of the port's U-Net (``encoder.*`` /
    ``decoder.*``) or V-Net (models/vnet3d.py names) by its top-level
    module: the two backbones the reference's freeze flags reach
    (net_factory_args.py:14-17, model_3D.py:103-106). Any other model
    raises, as JAX's freeze.py does (the 3-D U-Nets among them)."""
    top = name.split(".", 1)[0]
    if top in ("encoder", "decoder"):
        return top
    if top in _VNET_ENCODER:
        return "encoder"
    if top in _VNET_DECODER:
        return "decoder"
    raise ValueError(
        f"cannot classify parameter {name!r} as encoder/decoder; "
        "--train_encoder/--train_decoder support the unet/vnet backbones")


def model_param_labels(model: torch.nn.Module, train_encoder: bool,
                       train_decoder: bool) -> dict:
    """Label every parameter of ``model`` 'train' or 'freeze' by name."""
    return {name: "train" if (train_encoder if _part_of(name) == "encoder"
                              else train_decoder) else "freeze"
            for name, _ in model.named_parameters()}


def apply_freeze(model: torch.nn.Module, train_encoder: bool,
                 train_decoder: bool) -> list:
    """Freeze the halves of ``model`` that do not train, in place
    (``requires_grad_(False)``), and return the parameters that do, for the
    optimizer. Every parameter trains when both halves do."""
    if train_encoder and train_decoder:
        return list(model.parameters())
    if type(model).__name__ not in ("UNet", "VNet"):
        # the U-Net variants name their halves encoder/decoder too, but
        # the flags reach only these two, as in JAX
        raise ValueError(
            f"cannot freeze an encoder/decoder half of "
            f"{type(model).__name__}: --train_encoder/--train_decoder "
            "support the unet/vnet backbones")
    labels = model_param_labels(model, train_encoder, train_decoder)
    params = []
    for name, p in model.named_parameters():
        if labels[name] == "train":
            params.append(p)
        else:
            p.requires_grad_(False)
    return params


def apply_deeplab_bn_freeze(model: torch.nn.Module) -> list:
    """Freeze every BatchNorm scale and bias of ``model`` in place and
    return the parameters that still train, for the optimizer: the
    reference sets requires_grad=False on every trunk BatchNorm
    (models/deeplab.py:90-103, 155-157, 176-180), so its optimizer never
    touches them (get_1x_lr_params_NOscale, deeplab.py:219-236). Their
    running statistics still move in train mode, as in JAX."""
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm) and m.affine:
            m.weight.requires_grad_(False)
            m.bias.requires_grad_(False)
    return [p for p in model.parameters() if p.requires_grad]
