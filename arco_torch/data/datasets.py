"""Host-side datasets (counterpart of arco_tpu/data/datasets.py): h5 slice
sets (ACDC/MMWHS), npz slices (Synapse/LiTS/JHU) and h5 volumes (LA heart).

Parity targets:
- BaseDataSetsWithIndex (build_dataset.py:18-95): train list
  `train_slices.list`, data at `data/slices/<case>.h5`; the first ``index``
  entries are the labeled pool (label_type=1), the rest unlabeled.
- Synapse_datasetWithIndex (build_dataset.py:127-199): npz slices
  `<case>.npz` (keys image/label), `_40` list variant for LiTS.
- RandomGenerator (dataloaders/dataset.py:180-201): zoom to output size,
  then one of rot90+flip / rotate(-20..20, order 0) / nothing, with the
  reference's elif-chain probabilities.
- LAHeart (dataloaders/la_heart.py:14-105): `train.list` +
  `<case>/mri_norm2.h5`, 3-D RandomRotFlip + RandomCrop to (112,112,80).
  Volumes are [W, H, D], depth last, as in the h5 files.

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


class VolumeDataset:
    """3D training volumes with the LA transforms: ``load(i)`` gives
    (image, label) [W, H, D]; ``get`` rotates, flips and crops them to
    ``patch_size``."""

    split = "train"
    transform = True

    def __len__(self):
        return len(self.sample_list)

    def get(self, idx: int, rng: np.random.RandomState):
        """One sample: image [W, H, D, 1] f32 (channels-last, as the JAX
        package returns it; the batch is made NCDHW on its way to the
        card), label [W, H, D] int32."""
        image, label = self.load(idx)
        if self.split == "train" and self.transform:
            image, label = random_rot_flip_3d(rng, image, label)
            image, label = random_crop_3d(rng, image, label, self.patch_size)
        return {"image": image.astype(np.float32)[..., None],
                "label": label.astype(np.int32), "idx": idx}


class LAHeartDataset(VolumeDataset):
    """LA 3D volume dataset (dataloaders/la_heart.py:14-204)."""

    def __init__(self, base_dir: str, split: str = "train",
                 index: Optional[int] = None, label_type: int = 0,
                 patch_size=(112, 112, 80), transform: bool = True):
        self.base_dir = base_dir
        self.split = split
        self.patch_size = tuple(patch_size)
        self.transform = transform
        list_file = "train.list" if split == "train" else "test.list"
        own = os.path.join(base_dir, list_file)
        samples = _read_list(own if os.path.exists(own)
                             else os.path.join(base_dir, "..", list_file))
        if split == "train" and index is not None:
            samples = samples[:index] if label_type == 1 else samples[index:]
        self.sample_list = samples

    def load(self, idx: int):
        return read_h5(os.path.join(self.base_dir, self.sample_list[idx],
                                    "mri_norm2.h5"))


class InMemoryVolumes(VolumeDataset):
    """Training volumes held in memory ([(image, label)] [W, H, D] each),
    with LAHeartDataset's transforms: for a machine without h5py."""

    def __init__(self, volumes, patch_size=(112, 112, 80)):
        self.volumes = list(volumes)
        self.sample_list = [f"volume{i}" for i in range(len(self.volumes))]
        self.patch_size = tuple(patch_size)

    def load(self, idx: int):
        return self.volumes[idx]


def random_rot_flip_3d(rng, image, label):
    """la_heart.py:149-162: rot90 in-plane + random axis flip."""
    k = rng.randint(0, 4)
    image = np.rot90(image, k)
    label = np.rot90(label, k)
    axis = rng.randint(0, 2)
    image = np.flip(image, axis=axis).copy()
    label = np.flip(label, axis=axis).copy()
    return image, label


def pad_for_crop_3d(image, label, output_size):
    """random_crop_3d's symmetric zero padding of a volume that is not
    larger than the crop in every dim (la_heart.py:113-125)."""
    if (label.shape[0] <= output_size[0] or label.shape[1] <= output_size[1]
            or label.shape[2] <= output_size[2]):
        pads = [(p, p) for p in (max((o - n) // 2 + 3, 0)
                                 for o, n in zip(output_size, label.shape))]
        image = np.pad(image, pads, mode="constant")
        label = np.pad(label, pads, mode="constant")
    return image, label


def random_crop_3d(rng, image, label, output_size):
    """la_heart.py:113-147: pad if needed then random crop."""
    image, label = pad_for_crop_3d(image, label, output_size)
    w, h, d = image.shape
    w1 = rng.randint(0, w - output_size[0] + 1)
    h1 = rng.randint(0, h - output_size[1] + 1)
    d1 = rng.randint(0, d - output_size[2] + 1)
    sl = np.s_[w1:w1 + output_size[0], h1:h1 + output_size[1],
               d1:d1 + output_size[2]]
    return image[sl], label[sl]
