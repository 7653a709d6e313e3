"""String -> model factories (counterpart of arco_tpu/models/factory.py).

Every key of JAX's ``net_factory`` and ``net_factory_3d`` is ported; an
unknown key raises.

``img_size`` (an int or (H, W)) is the input size of the models whose
parameters depend on it: ViT_Seg's position embedding and Swin-UNet's
window sizes (JAX takes both from the init input).

The CLIs take the keys their JAX counterparts run (found by running the
JAX CLIs on each key at a small size on the CPU), and ``check_model`` /
``check_model_3d`` say why a key is refused:

- ``train_arco_2d``'s FeatureExtractor fuses the U-Net's five maps (256,
  128, 64, 32, 16): nnU-Net's six fail it, as every other map set does;
- ``test_2d`` and ``pretrain_2d`` unpack a (logits, latent, feature maps)
  forward, which the four-output variants do not return; nnU-Net 2D runs
  through both (its lattice needs sizes divisible by 32);
- ``train_arco_3d`` builds its FeatureExtractor and 3-D heads on the
  V-Net's maps (128, 64, 32, 16, 16): JAX's fails building its state
  (``init_arco_state``) for nnUNet, voxresnet and unet_3D, so only vnet
  runs;
- ``test_3d`` and ``pretrain_3d`` run every 3D key whose forward is a
  (logits, latent, feature maps) triple: vnet, unet_3D, attention_unet,
  voxresnet and nnUNet (whose lattice needs H and W divisible by 64 and Z
  by 4: a 128x128x80 patch, not LA's 112x112x80); unet_3D_dv_semi returns
  its four deep-supervision heads.

The natural-image CLIs build their models with ``natural_model`` and
``check_natural_model`` says which they take:

- ``train_arco_natural`` takes unet (3 input channels), deeplabv2 and
  deeplabv3 (its argparse choices), each with backbone resnet50 or
  resnet101 for the DeepLabs;
- ``eval_natural`` takes every ``deeplab*`` key that ``model_generator``
  maps to DeepLab-v2 or v3+ (the 2branch keys return four values) and the
  2D keys ``test_2d`` runs, with 3 input channels;
- the U-Net's pooled maps must concatenate with its upsampled ones, so its
  crop must be divisible by 16: JAX's fails at Pascal's 321 (found by
  running its init at 320, 321, 64, 65, 48, 40 and 33); pass
  ``--crop_size 320``.
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
    "nnUNet": (480, 256, 128, 64, 32, 16),
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
    if net_type == "nnUNet":
        from arco_torch.models.nnunet import initialize_network
        return initialize_network(num_classes=class_num, threeD=False,
                                  input_channels=in_chns)
    raise NotImplementedError(f"net_type={net_type!r} is not a 2D model")


# the 3D keys each 3D CLI runs (see the module docstring)
_RUNS_3D = {"train_arco_3d": ("vnet",),
            "test_3d": ("vnet", "unet_3D", "attention_unet", "voxresnet",
                        "nnUNet")}
_RUNS_3D["pretrain_3d"] = _RUNS_3D["test_3d"]
_WHY_3D = {
    "unet_3D_dv_semi": "returns its four deep-supervision heads, not "
                       "(logits, latent, feature maps)",
    "train_arco_3d": "does not give the V-Net's feature maps (128, 64, 32, "
                     "16, 16) that the 3-D FeatureExtractor and heads fuse"}


def check_model_3d(net_type: str, cli: str) -> None:
    """Raise ValueError unless the 3D ``cli`` ("train_arco_3d",
    "pretrain_3d" or "test_3d") runs ``net_type``, as its JAX counterpart
    does; the message names the model and why."""
    if net_type in _RUNS_3D[cli]:
        return
    if net_type == "unet_3D_dv_semi":
        why = _WHY_3D[net_type]
    elif net_type in _RUNS_3D["test_3d"]:
        why = _WHY_3D[cli]
    else:
        why = "is not a 3D model"
    raise ValueError(f"{cli}: model {net_type!r} {why}")


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
    if net_type == "voxresnet":
        from arco_torch.models.voxresnet import VoxResNet
        return VoxResNet(in_chns=in_chns, class_num=class_num, **kwargs)
    if net_type == "nnUNet":
        from arco_torch.models.nnunet import initialize_network
        return initialize_network(num_classes=class_num, threeD=True,
                                  input_channels=in_chns)
    raise NotImplementedError(f"net_type={net_type!r} is not a 3D model")


# the natural-image CLIs' keys (see the module docstring)
NATURAL_TRAIN = ("unet", "deeplabv2", "deeplabv3")
NATURAL_BACKBONES = ("resnet50", "resnet101")


def check_natural_model(model: str, crop, cli: str) -> None:
    """Raise ValueError unless the natural ``cli`` ("train_arco_natural" or
    "eval_natural") runs ``model`` at ``crop`` (H, W), as its JAX
    counterpart does; the message names the model and why."""
    if model.startswith("deeplab"):
        if "2branch" in model.lower():
            raise ValueError(
                f"{cli}: model {model!r} returns four values (feature_"
                "instance, feature_part, logits, None), not (logits, "
                "latent, feature maps)")
        if cli == "train_arco_natural" and model not in NATURAL_TRAIN:
            raise ValueError(f"{cli}: model {model!r} is not one of "
                             f"{NATURAL_TRAIN}")
        return
    if cli == "train_arco_natural" and model not in NATURAL_TRAIN:
        raise ValueError(f"{cli}: model {model!r} is not one of "
                         f"{NATURAL_TRAIN}")
    check_model(model, "test_2d")
    if model == "unet" and any(int(c) % 16 for c in crop):
        raise ValueError(
            f"{cli}: the U-Net's skip connections need a crop divisible by "
            f"16, not {tuple(crop)} (pass --crop_size, e.g. 320)")


def natural_model(model: str, backbone: str = "resnet101",
                  num_classes: int = 21):
    """The natural-image CLIs' model: a DeepLab (``model_generator``) for
    the ``deeplab*`` keys, else the 2D model with 3 input channels."""
    if model.startswith("deeplab"):
        from arco_torch.models.deeplab import model_generator
        return model_generator(model, backbone, num_classes=num_classes)
    return net_factory(model, in_chns=3, class_num=num_classes)
