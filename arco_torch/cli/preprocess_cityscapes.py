"""Offline Cityscapes preprocessing (counterpart of
arco_tpu/cli/preprocess_cityscapes.py: host only, numpy, PIL imported where
a file is read or written).

Reference: dataset/cityscapes_preprocessing.py (whole file). Two stages:

1. flatten — resize leftImg8bit train/val to 1024x512 (bilinear) and
   gtFine *_labelIds.png to 1024x512 (nearest), renumbering city-sorted
   files to sequential `<root>/images/{train,val}/<i>.png` and
   `<root>/labels/{train,val}/<i>.png` trees (the layout
   data/natural.py CityscapesDataset consumes);
2. partial — per seed, grow the `train_p{1,5,25}_{seed}` partial-label
   regimes by iterative 5x5 dilation from one random pixel per valid
   class (void classes are the reference's raw labelId list), fill 0,
   plus the one-pixel `train_p0_{seed}` regime.

Usage:
    python -m arco_torch.cli.preprocess_cityscapes --root /data/cityscapes \
        [--stages flatten partial] [--seeds 0 1 2] [--percents 25 5 1]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from arco_torch.data.preprocessing import partial_label_mask

# raw-labelId classes the reference treats as void when seeding partial
# masks (cityscapes_preprocessing.py:88)
VOID = (0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30)
SIZE = (1024, 512)  # PIL (width, height)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True,
                    help="cityscapes root containing leftImg8bit/ + gtFine/ "
                         "(flatten) and/or images/ + labels/ (partial)")
    ap.add_argument("--stages", nargs="+", default=["flatten", "partial"],
                    choices=["flatten", "partial"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--percents", type=int, nargs="+", default=[25, 5, 1])
    return ap


def _resize_tree(src_glob: str, dst_dir: str, nearest: bool,
                 suffix: str = "*.png") -> int:
    from PIL import Image

    os.makedirs(dst_dir, exist_ok=True)
    counter = 0
    for city in sorted(glob.glob(src_glob)):
        for path in sorted(glob.glob(os.path.join(city, suffix))):
            im = Image.open(path)
            im = im.resize(SIZE, resample=Image.NEAREST if nearest
                           else Image.BILINEAR)
            im.save(os.path.join(dst_dir, f"{counter}.png"))
            counter += 1
    return counter


def flatten(root: str, progress=print) -> None:
    for split in ("train", "val"):
        n = _resize_tree(os.path.join(root, "leftImg8bit", split, "*"),
                         os.path.join(root, "images", split), nearest=False)
        progress(f"{split} RGB: {n} images")
        n = _resize_tree(os.path.join(root, "gtFine", split, "*"),
                         os.path.join(root, "labels", split), nearest=True,
                         suffix="*_labelIds.png")
        progress(f"{split} labels: {n} images")


def partial(root: str, seeds, percents, progress=print) -> None:
    from PIL import Image

    label_dir = os.path.join(root, "labels", "train")
    label_list = sorted(glob.glob(os.path.join(label_dir, "*.png")),
                        key=lambda p: int(os.path.splitext(
                            os.path.basename(p))[0]))
    if not label_list:
        raise FileNotFoundError(f"no label pngs under {label_dir}")
    regimes = [p / 100.0 for p in percents] + [0.0]
    names = list(percents) + [0]
    for seed in seeds:
        rng = np.random.RandomState(seed)
        dirs = {}
        for p, frac in zip(names, regimes):
            d = os.path.join(root, "labels", f"train_p{p}_{seed}")
            os.makedirs(d, exist_ok=True)
            dirs[frac] = d
        for path in label_list:
            im = np.array(Image.open(path))
            im_id = os.path.splitext(os.path.basename(path))[0]
            for frac, d in dirs.items():
                # the reference fills UNLABELED with 0 here (a void class
                # in the raw labelId space), not 255
                out = partial_label_mask(im, frac, void_classes=VOID,
                                         fill_value=0, rng=rng)
                Image.fromarray(out.astype(im.dtype)).save(
                    os.path.join(d, f"{im_id}.png"))
        progress(f"Partial Label images for seed {seed} has completed.")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if "flatten" in args.stages:
        flatten(args.root)
    if "partial" in args.stages:
        partial(args.root, args.seeds, args.percents)
    print("All Done.")


if __name__ == "__main__":
    main()
