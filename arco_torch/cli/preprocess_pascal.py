"""Offline Pascal VOC partial-label preprocessing (counterpart of
arco_tpu/cli/preprocess_pascal.py: host only, numpy, PIL imported where a
file is read or written).

Reference: dataset/pascal_preprocessing.py (whole file). Produces the
`SegmentationClassAug_p{1,5,25}_{seed}` and `_p0_{seed}` directory trees
the natural-image trainers consume via ``--apply_partial p5_0``
(data/natural.py PascalDataset._paths): per label png, per valid class,
one random seed pixel grown by iterative 5x5 dilation to the target
fraction of the class area (p0 = the single seed pixel), everything else
set to the 255 ignore index.

Usage:
    python -m arco_torch.cli.preprocess_pascal --label-root \
        /data/pascal/SegmentationClassAug [--seeds 0 1 2] \
        [--percents 25 5 1] [--with-p0]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from arco_torch.data.preprocessing import partial_label_mask

VOID = (255,)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--label-root", required=True,
                    help="directory of full label pngs "
                         "(e.g. .../SegmentationClassAug)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--percents", type=int, nargs="+", default=[25, 5, 1],
                    help="partial-label percentages (reference perc = "
                         "[0.25, 0.05, 0.01])")
    ap.add_argument("--with-p0", action="store_true", default=True,
                    help="also emit the one-pixel-per-class p0 regime")
    ap.add_argument("--no-p0", dest="with_p0", action="store_false")
    return ap


def process(label_root: str, seeds, percents, with_p0: bool = True,
            progress=print) -> None:
    from PIL import Image

    label_list = sorted(glob.glob(os.path.join(label_root, "*.png")))
    if not label_list:
        raise FileNotFoundError(f"no label pngs under {label_root}")
    regimes = [p / 100.0 for p in percents] + ([0.0] if with_p0 else [])
    for seed in seeds:
        # one RandomState per seed shared across regimes, matching the
        # reference's per-seed np.random.seed + sequential draws
        rng = np.random.RandomState(seed)
        dirs = {}
        for p, frac in zip(percents + ([0] if with_p0 else []), regimes):
            d = f"{label_root}_p{p}_{seed}"
            os.makedirs(d, exist_ok=True)
            dirs[frac] = d
        for path in label_list:
            im = np.array(Image.open(path))
            im_id = os.path.splitext(os.path.basename(path))[0]
            for frac, d in dirs.items():
                out = partial_label_mask(im, frac, void_classes=VOID,
                                         fill_value=255, rng=rng)
                Image.fromarray(out.astype(im.dtype)).save(
                    os.path.join(d, f"{im_id}.png"))
        progress(f"Partial Label images for seed {seed} has completed.")


def main(argv=None):
    args = build_parser().parse_args(argv)
    process(args.label_root, args.seeds, args.percents, args.with_p0)
    print("All Done.")


if __name__ == "__main__":
    main()
