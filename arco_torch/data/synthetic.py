"""Synthetic datasets for tests and smoke runs (counterpart of
arco_tpu/data/synthetic.py).

``make_acdc_like`` writes the ACDC layout (h5 slices and volumes) and
``make_la_like`` the LA layout (h5 volumes) from the same ``RandomState``
stream as the JAX version, so both packages read the same tree.
``make_synapse_like`` writes the Synapse npz layout, which needs no h5py;
``la_volume`` makes one LA-like volume in memory. ``make_pascal_like``
writes the Pascal VOC layout (JPEG images, PNG labels, the split lists) at
VOC's image sizes with PIL.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def _shape_image(rng, size, num_classes):
    """Image with per-class blobs so segmentation is learnable."""
    h, w = size
    label = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for c in range(1, num_classes):
        cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4,
                                                              3 * w // 4)
        r = rng.randint(h // 10, h // 5)
        label[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
    image = (label.astype(np.float32) / max(num_classes - 1, 1)
             + 0.08 * rng.randn(h, w).astype(np.float32))
    image = np.clip(image, 0, 1.5)
    return image, label


def make_volume(rng, size, num_classes: int, depth: int):
    """(image, label) [depth, H, W]: a stack of ``_shape_image`` slices."""
    pairs = [_shape_image(rng, size, num_classes) for _ in range(depth)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _write_h5(path, image, label):
    if h5py is None:
        raise ImportError(f"writing {path} needs h5py, which is not "
                          "installed")
    with h5py.File(path, "w") as f:
        f.create_dataset("image", data=image)
        f.create_dataset("label", data=label)


def make_acdc_like(root: str, n_train: int = 24, n_val: int = 2,
                   size=(64, 64), num_classes: int = 4, depth: int = 4,
                   seed: int = 0):
    """ACDC layout: <root>/train_slices.list, data/slices/<case>.h5 (2D),
    val.list + data/<case>.h5 (3D volumes for eval)."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "data", "slices"), exist_ok=True)
    cases = []
    for i in range(n_train):
        case = f"patient{i:03d}_frame01_slice_{i % 8}"
        image, label = _shape_image(rng, size, num_classes)
        _write_h5(os.path.join(root, "data", "slices", f"{case}.h5"), image,
                  label)
        cases.append(case)
    with open(os.path.join(root, "train_slices.list"), "w") as f:
        f.write("\n".join(cases) + "\n")

    vol_cases = []
    for i in range(n_val):
        case = f"patient{100 + i:03d}_volume"
        image, label = make_volume(rng, size, num_classes, depth)
        _write_h5(os.path.join(root, "data", f"{case}.h5"), image, label)
        vol_cases.append(case)
    for name in ("val.list", "test.list"):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(vol_cases) + "\n")
    return root


def make_synapse_like(root: str, n_train: int = 64, size=(256, 256),
                      num_classes: int = 4, seed: int = 0):
    """Synapse layout for training: <root>/train.txt and <root>/<case>.npz
    slices (keys image, label), as data.datasets.SynapseDataset reads
    them."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    cases = []
    for i in range(n_train):
        case = f"case{i:04d}_slice{i % 8:03d}"
        image, label = _shape_image(rng, size, num_classes)
        np.savez(os.path.join(root, f"{case}.npz"), image=image, label=label)
        cases.append(case)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(cases) + "\n")
    return root


def la_volume(rng, size=(48, 48, 32)):
    """(image f32, label uint8) [W, H, D]: one sphere phantom of label 1
    plus noise, as make_la_like draws it."""
    h, w, d = size
    label = np.zeros(size, np.uint8)
    cy, cx, cz = (rng.randint(h // 4, 3 * h // 4),
                  rng.randint(w // 4, 3 * w // 4),
                  rng.randint(d // 4, 3 * d // 4))
    r = rng.randint(min(size) // 8, min(size) // 4)
    yy, xx, zz = np.mgrid[0:h, 0:w, 0:d]
    label[(yy - cy) ** 2 + (xx - cx) ** 2 + (zz - cz) ** 2 < r * r] = 1
    image = (label.astype(np.float32)
             + 0.2 * rng.randn(*size).astype(np.float32))
    return image, label


def make_la_like(root: str, n_train: int = 8, size=(48, 48, 32),
                 seed: int = 0):
    """LA layout: <root>/train.list + <case>/mri_norm2.h5 volumes; the
    first two cases are the test.list."""
    rng = np.random.RandomState(seed)
    cases = []
    for i in range(n_train):
        case = f"la_case_{i:03d}"
        os.makedirs(os.path.join(root, case), exist_ok=True)
        _write_h5(os.path.join(root, case, "mri_norm2.h5"),
                  *la_volume(rng, size))
        cases.append(case)
    with open(os.path.join(root, "train.list"), "w") as f:
        f.write("\n".join(cases) + "\n")
    with open(os.path.join(root, "test.list"), "w") as f:
        f.write("\n".join(cases[:2]) + "\n")
    return root


# VOC 2012's common image sizes (H, W)
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333), (360, 480))


def make_pascal_like(root: str, n_train: int = 24, n_val: int = 4,
                     num_classes: int = 21, classes_per_image: int = 4,
                     seed: int = 0) -> str:
    """A Pascal VOC tree (JPEGImages/, SegmentationClassAug/,
    ImageSets/Segmentation/{train,val}.txt) of VOC-sized images: each
    holds ``classes_per_image`` foreground blobs over the background, the
    classes taken in turn so every class appears, a 255 (void) border
    around each blob as in VOC, and colours that follow the classes."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    palette = rng.randint(0, 256, (num_classes, 3))
    for d in ("JPEGImages", "SegmentationClassAug",
              os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    k = 0
    for split, n in (("train", n_train), ("val", n_val)):
        names = []
        for i in range(n):
            h, w = VOC_SIZES[i % len(VOC_SIZES)]
            label = np.zeros((h, w), np.uint8)
            yy, xx = np.mgrid[0:h, 0:w]
            for _ in range(classes_per_image):
                c = k % (num_classes - 1) + 1
                k += 1
                cy, cx = rng.randint(h // 6, 5 * h // 6), \
                    rng.randint(w // 6, 5 * w // 6)
                r = rng.randint(min(h, w) // 10, min(h, w) // 4)
                d2 = (yy - cy) ** 2 + (xx - cx) ** 2
                label[(d2 < (r + 3) ** 2) & (d2 >= r * r)] = 255
                label[d2 < r * r] = c
            image = palette[np.where(label == 255, 0, label)] \
                + rng.randint(-30, 30, (h, w, 3))
            name = f"{split}_{i:04d}"
            Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).save(
                os.path.join(root, "JPEGImages", f"{name}.jpg"))
            Image.fromarray(label).save(
                os.path.join(root, "SegmentationClassAug", f"{name}.png"))
            names.append(name)
        with open(os.path.join(root, "ImageSets", "Segmentation",
                               f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root
