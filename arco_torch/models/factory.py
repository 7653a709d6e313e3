"""String -> model factories (counterpart of arco_tpu/models/factory.py).

Ported so far: the 2D ``unet`` and the 3D ``vnet``; the other keys raise."""

from __future__ import annotations


def net_factory(net_type: str = "unet", in_chns: int = 1, class_num: int = 3,
                **kwargs):
    if net_type == "unet":
        from arco_torch.models.unet2d import UNet
        return UNet(in_chns=in_chns, class_num=class_num, **kwargs)
    raise NotImplementedError(f"net_type={net_type!r} is not ported yet")


def net_factory_3d(net_type: str = "vnet", in_chns: int = 1,
                   class_num: int = 2, **kwargs):
    if net_type == "vnet":
        from arco_torch.models.vnet3d import VNet
        return VNet(n_channels=in_chns, n_classes=class_num, **kwargs)
    raise NotImplementedError(
        f"net_type={net_type!r} is not ported yet: the 3-D models other "
        "than vnet wait for ROADMAP Queue A item 3 (UNet3D, "
        "AttentionUNet3D)")
