"""Synthetic 2D datasets for tests and smoke runs (counterpart of
arco_tpu/data/synthetic.py, its 2D part).

``make_acdc_like`` writes the ACDC layout (h5 slices and volumes) from the
same ``RandomState`` stream as the JAX version, so both packages read the
same tree. ``make_synapse_like`` writes the Synapse npz layout, which needs
no h5py.
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
