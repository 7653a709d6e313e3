"""Natural-image (Cityscapes/Pascal) evaluation of a port checkpoint: mean
IoU and per-class IoU (counterpart of arco_tpu/cli/eval_natural.py, flag
for flag, plus ``--device``).

    python -m arco_torch.cli.eval_natural --root_path ../data/pascal \
        --dataset pascal --model deeplabv2 --backbone resnet101

Prints one JSON line, JAX's schema: {"iteration", "miou",
"per_class_iou"}. The val images go through the dataset's geometric
transform with RandomState(0), as in JAX (rescale and crop to
``--crop_size``, default the dataset's), and the forward runs on the card
in f32 with TF32 off, in eval mode. ``--model`` takes the DeepLab keys and
the 2D keys with 3 input channels (models/factory.py:check_natural_model).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from arco_torch import resolve_device
from arco_torch.data.natural import NaturalImageDataset
from arco_torch.models.factory import (NATURAL_BACKBONES,
                                       check_natural_model, natural_model)
from arco_torch.train import checkpoint as ckpt


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, required=True)
    p.add_argument("--dataset", type=str, default="pascal",
                   choices=["pascal", "cityscapes"])
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--backbone", type=str, default="resnet101",
                   choices=list(NATURAL_BACKBONES))
    p.add_argument("--label_num", type=int, default=5)
    p.add_argument("--snapshot_dir", type=str, default="../model")
    p.add_argument("--exp", type=str, default="natural/arco")
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--crop_size", type=int, default=None,
                   help="override the dataset's default crop")
    p.add_argument("--num_classes", type=int, default=None,
                   help="override the dataset's class count")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    defaults = NaturalImageDataset.DEFAULTS[args.dataset]
    num_classes = args.num_classes or defaults["num_classes"]
    crop = ((args.crop_size, args.crop_size) if args.crop_size else None)
    check_natural_model(args.model, crop or defaults["crop_size"],
                        "eval_natural")
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    snapshot = os.path.join(args.snapshot_dir,
                            f"{args.exp}_{args.label_num}_labeled",
                            args.model)
    step = args.iteration or ckpt.latest_step(snapshot)
    if step is None:
        raise SystemExit(f"no checkpoint under {snapshot}")
    model = natural_model(args.model, args.backbone, num_classes)
    model.load_state_dict(ckpt.load_model_params(snapshot, step))
    model = model.to(device).eval()

    ds = NaturalImageDataset(args.root_path, args.dataset, "val",
                             crop_size=crop)
    inter = np.zeros(num_classes, np.int64)
    union = np.zeros(num_classes, np.int64)
    rng = np.random.RandomState(0)
    for i in range(len(ds)):
        sample = ds.get(i, rng)
        x = torch.from_numpy(np.ascontiguousarray(
            sample["image"].transpose(2, 0, 1)[None])).to(device)
        with torch.no_grad():
            logits = model(x)[0]
        pred = logits.argmax(1)[0].cpu().numpy()
        label = sample["label"]
        valid = label >= 0
        for c in range(num_classes):
            pc = (pred == c) & valid
            lc = label == c
            inter[c] += np.logical_and(pc, lc).sum()
            union[c] += np.logical_or(pc, lc).sum()
    iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
    result = {"iteration": step, "miou": float(np.nanmean(iou)),
              "per_class_iou": iou.tolist()}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
