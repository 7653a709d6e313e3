"""String -> model factories (counterpart of arco_tpu/models/factory.py).

Ported: every 2D key but ``nnUNet`` and the 3D ``vnet``, ``unet_3D``,
``unet_3D_dv_semi`` and ``attention_unet``; the other keys raise.

``img_size`` (an int or (H, W)) is the input size of the models whose
parameters depend on it: ViT_Seg's position embedding and Swin-UNet's
window sizes (JAX takes both from the init input).

The CLIs take the keys their JAX counterparts run, and ``check_model``
says why a key is refused: ``train_arco_2d``'s FeatureExtractor fuses the
U-Net's five maps (256, 128, 64, 32, 16); ``test_2d`` and ``pretrain_2d``
unpack a (logits, latent, feature maps) forward, which the four-output
variants do not return.
"""

from __future__ import annotations

ARCO_FEATURE_MAPS = (256, 128, 64, 32, 16)

# the channel widths of each 2D model's feature maps (coarse -> fine); the
# four-output variants are None
FEATURE_MAPS = {
    "unet": ARCO_FEATURE_MAPS, "unet_stego": ARCO_FEATURE_MAPS,
    "enet": (128, 64, 16), "pnet": (64,) * 5,
    "efficient_unet": (384, 256, 128, 64, 32, 16),
    "ViT_Seg": (512, 256, 128, 64, 16), "swin_unet": (96, 192, 384, 768),
    "unet_har": None, "unet_ds": None, "unet_cct": None, "unet_urpc": None,
}

_OUTPUTS = {"unet_har": "(logits, latent, feature maps, BatchNorm taps)",
            "unet_ds": "(logits, dp3, dp2, dp1)",
            "unet_cct": "(main logits, aux1, aux2, aux3)",
            "unet_urpc": "(logits, dp3, dp2, dp1)"}


def check_model(net_type: str, cli: str) -> None:
    """Raise ValueError unless the 2D ``cli`` ("train_arco_2d",
    "pretrain_2d" or "test_2d") runs ``net_type``, as its JAX counterpart
    does; the message names the model and why."""
    if net_type not in FEATURE_MAPS:
        raise ValueError(f"{cli}: unknown or unported model {net_type!r}")
    maps = FEATURE_MAPS[net_type]
    if maps is None:
        raise ValueError(
            f"{cli}: model {net_type!r} returns four values "
            f"{_OUTPUTS[net_type]}, not (logits, latent, feature maps)")
    if cli == "train_arco_2d" and maps != ARCO_FEATURE_MAPS:
        raise ValueError(
            f"{cli}: the feature maps of {net_type!r} {list(maps)} do not "
            f"match the ARCO FeatureExtractor's {ARCO_FEATURE_MAPS}")


def net_factory(net_type: str = "unet", in_chns: int = 1, class_num: int = 3,
                img_size=256, **kwargs):
    from arco_torch.models import unet2d
    simple = {"unet": unet2d.UNet, "unet_ds": unet2d.UNetDS,
              "unet_cct": unet2d.UNetCCT, "unet_urpc": unet2d.UNetURPC}
    if net_type in simple:
        return simple[net_type](in_chns=in_chns, class_num=class_num,
                                **kwargs)
    if net_type in ("unet_har", "unet_stego"):
        from arco_torch.models import unet2d_variants as v
        cls = v.UNetHAR if net_type == "unet_har" else v.UNetSTEGO
        return cls(in_chns=in_chns, class_num=class_num, **kwargs)
    if net_type == "enet":
        from arco_torch.models.enet import ENet
        return ENet(in_channels=in_chns, num_classes=class_num, **kwargs)
    if net_type == "pnet":
        from arco_torch.models.pnet import PNet2D
        return PNet2D(in_chns=in_chns, num_classes=class_num, **kwargs)
    if net_type == "efficient_unet":
        from arco_torch.models.efficientunet import EffiUNet
        return EffiUNet(num_classes=class_num, in_chns=in_chns, **kwargs)
    if net_type == "ViT_Seg":
        from arco_torch.models.transunet import VisionTransformerSeg
        return VisionTransformerSeg(img_size=img_size, num_classes=class_num,
                                    in_chns=in_chns, **kwargs)
    if net_type == "swin_unet":
        from arco_torch.models.swin_unet import SwinUnet
        return SwinUnet(img_size=img_size, num_classes=class_num,
                        in_chns=in_chns, **kwargs)
    raise NotImplementedError(
        f"net_type={net_type!r} is not ported yet: nnUNet comes with the "
        "rest of the zoo (ROADMAP Queue A item 4)")


def net_factory_3d(net_type: str = "vnet", in_chns: int = 1,
                   class_num: int = 2, **kwargs):
    if net_type == "vnet":
        from arco_torch.models.vnet3d import VNet
        return VNet(n_channels=in_chns, n_classes=class_num, **kwargs)
    from arco_torch.models import unet3d
    cls = {"unet_3D": unet3d.UNet3D, "unet_3D_dv_semi": unet3d.UNet3DDVSemi,
           "attention_unet": unet3d.AttentionUNet3D}.get(net_type)
    if cls is not None:
        return cls(in_channels=in_chns, n_classes=class_num, **kwargs)
    raise NotImplementedError(
        f"net_type={net_type!r} is not ported yet: voxresnet and nnUNet "
        "come with the rest of the zoo (ROADMAP Queue A item 4)")
