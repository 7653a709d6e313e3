"""Natural-image branch data: Cityscapes / Pascal VOC datasets and the
label-budget index selection (counterpart of arco_tpu/data/natural.py,
copied: numpy and scipy on the host).

Parity targets (code/dataset/build_dataset.py):
- transform (:16-77): random rescale + reflect-pad + random crop + hflip +
  ImageNet normalization, invalid label 255 -> -1 (the photometric part
  runs on the device in the train step);
- cityscapes_class_map (:81-106): 34 -> 19 trainId remap;
- get_pascal_idx / get_cityscapes_idx (:109-199): class-balanced labeled-set
  selection: keep sampling images until every class has >= label_num
  labeled examples;
- BuildDataset / BuildDataLoader (:201-343) with per-dataset crop/batch
  defaults;
- colormaps (:345-404).

Images are decoded with PIL, which is imported where a file is read:
without it, reading a file raises and names PIL.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

CITYSCAPES_VOID = (0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30)
CITYSCAPES_MAP = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7,
                  21: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14,
                  28: 15, 31: 16, 32: 17, 33: 18}


def cityscapes_class_map(mask: np.ndarray) -> np.ndarray:
    """34-class ids -> 19 trainIds, void -> 255 (build_dataset.py:81-106)."""
    out = np.full_like(mask, 255)
    for src, dst in CITYSCAPES_MAP.items():
        out[mask == src] = dst
    return out


def class_balanced_idx(labels_fn, indices, num_classes: int,
                       label_num: int, seed: int = 0,
                       min_pixels: int = 0) -> Tuple[List[int], List[int]]:
    """Class-balanced labeled-set selection (get_pascal_idx semantics,
    build_dataset.py:109-152): shuffle, then greedily add images while any
    class has fewer than label_num labeled images containing it."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(list(indices))
    counts = np.zeros(num_classes, np.int64)
    labeled, unlabeled = [], []
    for idx in order:
        if (counts >= label_num).all():
            unlabeled.append(int(idx))
            continue
        mask = labels_fn(idx)
        present = [c for c in np.unique(mask)
                   if 0 <= c < num_classes
                   and (mask == c).sum() > min_pixels]
        if any(counts[c] < label_num for c in present):
            labeled.append(int(idx))
            for c in present:
                counts[c] += 1
        else:
            unlabeled.append(int(idx))
    return labeled, unlabeled


def read_image(path: str, mode: Optional[str] = None) -> np.ndarray:
    """A decoded image file as an array (``mode`` "RGB" converts)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL (Pillow), which is "
                          "not installed") from e
    with Image.open(path) as im:
        return np.asarray(im.convert(mode) if mode else im)


class NaturalImageDataset:
    """Cityscapes/Pascal folder dataset (BuildDataset,
    build_dataset.py:201-257)."""

    # per-dataset defaults (BuildDataLoader, build_dataset.py:262-280)
    DEFAULTS = {
        "cityscapes": {"crop_size": (512, 512), "num_classes": 19,
                       "scale_size": (1.0, 1.0), "batch_size": 2},
        "pascal": {"crop_size": (321, 321), "num_classes": 21,
                   "scale_size": (0.5, 1.5), "batch_size": 10},
    }

    def __init__(self, root: str, dataset: str = "pascal",
                 split: str = "train", idx_list: Optional[List] = None,
                 crop_size=None, scale_size=None,
                 apply_partial: Optional[str] = None):
        self.root = root
        self.dataset = dataset
        self.split = split
        cfg = self.DEFAULTS[dataset]
        self.crop_size = tuple(crop_size or cfg["crop_size"])
        self.scale_size = scale_size or cfg["scale_size"]
        self.num_classes = cfg["num_classes"]
        self.apply_partial = apply_partial
        self.idx_list = idx_list if idx_list is not None else \
            self._discover()

    def subset(self, indices) -> "NaturalImageDataset":
        """The same dataset over the images at ``indices`` of idx_list."""
        return NaturalImageDataset(
            self.root, self.dataset, self.split,
            idx_list=[self.idx_list[i] for i in indices],
            crop_size=self.crop_size, scale_size=self.scale_size,
            apply_partial=self.apply_partial)

    def _discover(self):
        if self.dataset == "pascal":
            lst = os.path.join(self.root, "ImageSets/Segmentation",
                               f"{self.split}.txt")
            with open(lst) as f:
                return [ln.strip() for ln in f if ln.strip()]
        img_dir = os.path.join(self.root, "images", self.split)
        names = []
        for city in sorted(os.listdir(img_dir)):
            for fn in sorted(os.listdir(os.path.join(img_dir, city))):
                names.append(os.path.join(city, fn))
        return names

    def __len__(self):
        return len(self.idx_list)

    def _paths(self, name):
        if self.dataset == "pascal":
            img = os.path.join(self.root, "JPEGImages", f"{name}.jpg")
            suffix = "" if self.apply_partial is None else \
                f"_{self.apply_partial}"
            lab = os.path.join(self.root, f"SegmentationClassAug{suffix}",
                               f"{name}.png")
        else:
            img = os.path.join(self.root, "images", self.split, name)
            lab = os.path.join(self.root, "labels", self.split,
                               name.replace("leftImg8bit", "gtFine_labelIds"))
        return img, lab

    def load(self, i: int):
        name = self.idx_list[i]
        img_path, lab_path = self._paths(name)
        image = read_image(img_path, "RGB").astype(np.float32) / 255.0
        label = read_image(lab_path).astype(np.int32)
        if self.dataset == "cityscapes":
            label = cityscapes_class_map(label).astype(np.int32)
        return image, label

    def get(self, i: int, rng: np.random.RandomState):
        image, label = self.load(i)
        image, label = geometric_transform(
            rng, image, label, crop_size=self.crop_size,
            scale_size=self.scale_size,
            augmentation=(self.split == "train"))
        image = (image - IMAGENET_MEAN) / IMAGENET_STD
        label = np.where(label == 255, -1, label)
        return {"image": image.astype(np.float32),
                "label": label.astype(np.int32), "idx": i}


def geometric_transform(rng, image, label, crop_size=(321, 321),
                        scale_size=(0.5, 1.5), augmentation=True):
    """Host-side geometric part of build_dataset.py:16-77 (rescale, reflect
    pad, random crop, hflip), drawing from ``rng`` in the JAX package's
    order; the photometrics run on the device."""
    from scipy.ndimage import zoom as nd_zoom
    h, w = image.shape[:2]
    ratio = rng.uniform(scale_size[0], scale_size[1])
    nh, nw = int(h * ratio), int(w * ratio)
    if (nh, nw) != (h, w):
        image = np.stack([nd_zoom(image[..., c], (nh / h, nw / w), order=1)
                          for c in range(image.shape[-1])], axis=-1)
        label = nd_zoom(label, (nh / h, nw / w), order=0)
    ch, cw = crop_size
    pad_h, pad_w = max(ch - nh, 0), max(cw - nw, 0)
    if pad_h or pad_w:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)),
                       mode="reflect")
        label = np.pad(label, ((0, pad_h), (0, pad_w)), mode="constant",
                       constant_values=255)
    hh, ww = label.shape
    y0 = rng.randint(0, hh - ch + 1)
    x0 = rng.randint(0, ww - cw + 1)
    image = image[y0:y0 + ch, x0:x0 + cw]
    label = label[y0:y0 + ch, x0:x0 + cw]
    if augmentation and rng.random_sample() > 0.5:
        image = image[:, ::-1].copy()
        label = label[:, ::-1].copy()
    return image, label


# ----------------------------------------------------------------- colormaps

def create_pascal_label_colormap() -> np.ndarray:
    """build_dataset.py:345-363 (bit-shuffle colormap)."""
    colormap = np.zeros((256, 3), np.int64)
    ind = np.arange(256, dtype=np.int64)
    for shift in reversed(range(8)):
        for channel in range(3):
            colormap[:, channel] |= ((ind >> channel) & 1) << shift
        ind >>= 3
    return colormap


def create_cityscapes_label_colormap() -> np.ndarray:
    """build_dataset.py:366-390."""
    return np.array([
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32]], np.uint8)
