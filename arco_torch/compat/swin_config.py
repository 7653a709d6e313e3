"""Reference Swin yaml recipe ingestion (counterpart of
arco_tpu/compat/swin_config.py).

The reference configures Swin-UNet through yacs CfgNode yaml files merged
over defaults, with recursive BASE-file chaining
(networks/config.py:175-187 `_update_config_from_file`, :222-229
`get_config`). This shim reads the same yaml files — including the BASE
chain and the `opts` KEY value override list of `merge_from_list` — and
produces constructor kwargs for arco_torch.models.swin_unet.SwinUnet, so a
user's existing reference recipe drives the rebuild unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

# yacs defaults relevant to model construction (networks/config.py:28-75)
_DEFAULTS: Dict[str, object] = {
    "DATA.IMG_SIZE": 224,
    "MODEL.NUM_CLASSES": 1000,
    "MODEL.DROP_RATE": 0.0,
    "MODEL.DROP_PATH_RATE": 0.1,
    "MODEL.PRETRAIN_CKPT": "./pretrained_ckpt/swin_tiny_patch4_window7_224.pth",
    "MODEL.SWIN.PATCH_SIZE": 4,
    "MODEL.SWIN.IN_CHANS": 3,
    "MODEL.SWIN.EMBED_DIM": 96,
    "MODEL.SWIN.DEPTHS": [2, 2, 6, 2],
    "MODEL.SWIN.DECODER_DEPTHS": [2, 2, 6, 2],
    "MODEL.SWIN.NUM_HEADS": [3, 6, 12, 24],
    "MODEL.SWIN.WINDOW_SIZE": 7,
    "MODEL.SWIN.MLP_RATIO": 4.0,
    "MODEL.SWIN.QKV_BIAS": True,
    "MODEL.SWIN.QK_SCALE": None,
    "MODEL.SWIN.APE": False,
    "MODEL.SWIN.PATCH_NORM": True,
    "MODEL.SWIN.FINAL_UPSAMPLE": "expand_first",
}


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def load_swin_yaml(cfg_file: str, opts: Optional[List[str]] = None
                   ) -> Dict[str, object]:
    """Flat {'MODEL.SWIN.DEPTHS': [...], ...} dict: yacs defaults, then the
    BASE chain depth-first (config.py:179-183), then the file itself, then
    the merge_from_list-style ``opts`` [KEY, value, KEY, value, ...]."""
    import yaml

    flat = dict(_DEFAULTS)

    def merge_file(path):
        with open(path) as f:
            tree = yaml.safe_load(f) or {}
        for base in tree.pop("BASE", [""]):
            if base:
                merge_file(os.path.join(os.path.dirname(path), base))
        flat.update(_flatten(tree))

    merge_file(cfg_file)
    if opts:
        it = iter(opts)
        for key, val in zip(it, it):
            flat[key] = yaml.safe_load(val) if isinstance(val, str) else val
    return flat


def swin_kwargs_from_yaml(cfg_file: str, opts: Optional[List[str]] = None,
                          **overrides) -> Dict[str, object]:
    """SwinUnet constructor kwargs from a reference yaml recipe.

    The reference builds SwinTransformerSys straight off these fields
    (vision_transformer.py:34-50); img_size/num_classes normally come from
    the trainer's argparse (train.py), so pass them via ``overrides``."""
    c = load_swin_yaml(cfg_file, opts)
    kwargs = dict(
        img_size=int(c["DATA.IMG_SIZE"]),
        num_classes=int(c["MODEL.NUM_CLASSES"]),
        in_chns=int(c["MODEL.SWIN.IN_CHANS"]),
        embed_dim=int(c["MODEL.SWIN.EMBED_DIM"]),
        depths=tuple(c["MODEL.SWIN.DEPTHS"]),
        depths_decoder=tuple(c["MODEL.SWIN.DECODER_DEPTHS"]),
        num_heads=tuple(c["MODEL.SWIN.NUM_HEADS"]),
        window_size=int(c["MODEL.SWIN.WINDOW_SIZE"]),
        mlp_ratio=float(c["MODEL.SWIN.MLP_RATIO"]),
        qkv_bias=bool(c["MODEL.SWIN.QKV_BIAS"]),
        qk_scale=c["MODEL.SWIN.QK_SCALE"],
        drop_rate=float(c["MODEL.DROP_RATE"]),
        drop_path_rate=float(c["MODEL.DROP_PATH_RATE"]),
        ape=bool(c["MODEL.SWIN.APE"]),
        patch_norm=bool(c["MODEL.SWIN.PATCH_NORM"]),
    )
    kwargs.update(overrides)
    return kwargs


def build_swin_from_yaml(cfg_file: str, opts: Optional[List[str]] = None,
                         **overrides):
    """Construct the SwinUnet module directly from a reference recipe."""
    from arco_torch.models.swin_unet import SwinUnet

    return SwinUnet(**swin_kwargs_from_yaml(cfg_file, opts, **overrides))
