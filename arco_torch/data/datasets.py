"""Host-side 2D datasets (counterpart of arco_tpu/data/datasets.py, its 2D
parts): h5 slice sets (ACDC/MMWHS) and npz slices (Synapse/LiTS/JHU).

Parity targets:
- BaseDataSetsWithIndex (build_dataset.py:18-95): train list
  `train_slices.list`, data at `data/slices/<case>.h5`; the first ``index``
  entries are the labeled pool (label_type=1), the rest unlabeled.
- Synapse_datasetWithIndex (build_dataset.py:127-199): npz slices
  `<case>.npz` (keys image/label), `_40` list variant for LiTS.
- RandomGenerator (dataloaders/dataset.py:180-201): zoom to output size,
  then one of rot90+flip / rotate(-20..20, order 0) / nothing, with the
  reference's elif-chain probabilities.

All transforms run in numpy/scipy on the host and consume the caller's
``RandomState`` in the JAX package's order. ``h5py`` is optional: without
it, reading an .h5 file raises.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
from scipy import ndimage

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_h5(path: str):
    """(image, label) arrays of an .h5 sample."""
    if h5py is None:
        raise ImportError(f"reading {path} needs h5py, which is not "
                          "installed")
    with h5py.File(path, "r") as f:
        return f["image"][:], f["label"][:]


def random_generator_2d(rng: np.random.RandomState, image: np.ndarray,
                        label: np.ndarray, output_size=(256, 256)):
    """RandomGenerator parity (dataloaders/dataset.py:180-201)."""
    x, y = image.shape
    if (x, y) != tuple(output_size):
        image = ndimage.zoom(image, (output_size[0] / x, output_size[1] / y),
                             order=0)
        label = ndimage.zoom(label, (output_size[0] / x, output_size[1] / y),
                             order=0)
    if rng.random_sample() > 0.5:
        k = rng.randint(0, 4)
        image = np.rot90(image, k)
        label = np.rot90(label, k)
        axis = rng.randint(0, 2)
        image = np.flip(image, axis=axis).copy()
        label = np.flip(label, axis=axis).copy()
    elif rng.random_sample() > 0.5:
        angle = rng.randint(-20, 20)
        image = ndimage.rotate(image, angle, order=0, reshape=False)
        label = ndimage.rotate(label, angle, order=0, reshape=False)
    return image.astype(np.float32), label.astype(np.int32)


class SliceDataset:
    """ACDC/MMWHS-style 2D slice dataset with labeled/unlabeled split."""

    def __init__(self, base_dir: str, split: str = "train",
                 index: Optional[int] = None, label_type: int = 0,
                 output_size=(256, 256), transform: bool = True,
                 list_name: Optional[str] = None):
        self.base_dir = base_dir
        self.split = split
        self.output_size = tuple(output_size)
        self.transform = transform
        if split == "train":
            # ACDC uses train_slices.list; MMWHS uses train_slices.txt with
            # ".h5" suffixes (dataloaders/dataset.py:51-66)
            list_path = os.path.join(base_dir,
                                     list_name or "train_slices.list")
            if list_name is None and not os.path.exists(list_path):
                list_path = os.path.join(base_dir, "train_slices.txt")
            samples = [s[:-3] if s.endswith(".h5") else s
                       for s in _read_list(list_path)]
            if index is not None:
                samples = samples[:index] if label_type == 1 \
                    else samples[index:]
        else:
            list_path = os.path.join(base_dir, list_name or "val.list")
            if list_name is None and not os.path.exists(list_path):
                list_path = os.path.join(base_dir, "test_vol.txt")
            samples = _read_list(list_path)
        self.sample_list = samples

    def __len__(self):
        return len(self.sample_list)

    def load(self, idx: int):
        case = self.sample_list[idx]
        if self.split == "train":
            return read_h5(os.path.join(self.base_dir, "data", "slices",
                                        f"{case}.h5"))
        return read_h5(os.path.join(self.base_dir, "data", f"{case}.h5"))

    def get(self, idx: int, rng: np.random.RandomState):
        """One sample: image [H, W, 1] f32 (channels-last, as the JAX
        package returns it; the batch is made NCHW on its way to the
        card), label [H, W] int32."""
        image, label = self.load(idx)
        if self.split == "train" and self.transform:
            image, label = random_generator_2d(rng, image, label,
                                               self.output_size)
        return {"image": image.astype(np.float32)[..., None],
                "label": label.astype(np.int32), "idx": idx}


class SynapseDataset(SliceDataset):
    """Synapse / LiTS / JHU npz slice dataset (build_dataset.py:127-199)."""

    def __init__(self, base_dir: str, list_dir: str, split: str = "train",
                 index: Optional[int] = None, label_type: int = 0,
                 output_size=(256, 256), transform: bool = True,
                 lits: bool = False):
        self.base_dir = base_dir
        self.split = split
        self.output_size = tuple(output_size)
        self.transform = transform
        suffix = "_40" if lits else ""
        name = os.path.join(list_dir, f"{split}{suffix}.txt")
        if not os.path.exists(name):
            name = os.path.join(list_dir, f"{split}{suffix}.list")
        samples = _read_list(name)
        if split == "train" and index is not None:
            samples = samples[:index] if label_type == 1 else samples[index:]
        self.sample_list = samples

    def load(self, idx: int):
        case = self.sample_list[idx]
        if self.split == "train":
            data = np.load(os.path.join(self.base_dir, f"{case}.npz"))
            return data["image"], data["label"]
        return read_h5(os.path.join(self.base_dir, f"{case}.npy.h5"))
