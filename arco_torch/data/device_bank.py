"""Device-resident training data (counterpart of
arco_tpu/data/device_bank.py): the 2D slice bank and the 3D volume bank.

The whole training slice set is staged on the device once: slices as f32,
labels as int8. The zoom to the output size runs on the host at staging
time (exact scipy, datasets.random_generator_2d). Every random transform of
datasets.random_generator_2d (identity, rot90 by k and a flip of one axis,
or a nearest rotation by an integer angle in [-20, 20)) is one of 49
pixel permutations with a validity mask, built once on the host as a
[49, H*W] index map; a batch is then one gather on the device. Per step
only the [B, 5] int32 parameter array crosses from the host, and the
batches are bit-identical to the host pipeline's for the same seed.

The 3D volumes (LA) are staged on the device once, after the host padding
rule of datasets.random_crop_3d; each sample's rot90, flip and crop then run
there on the staged volume, driven by draws made on the host in the host
pipeline's order, so nothing but launches crosses per step. They need one
shape and a square plane (rot90 in the first two dims keeps the shape).
"""

from __future__ import annotations

import numpy as np
import torch

from arco_torch import resolve_device
from arco_torch.data.datasets import pad_for_crop_3d

ROT_ANGLES = np.arange(-20, 20)  # random_generator_2d's randint(-20, 20)
# transform rows: 0 identity, 1 + 2k + axis rot90(k) then flip(axis),
# 9 + angle + 20 the rotation by angle
_N_ROTFLIP = 8


def _rotate_maps(h: int, w: int):
    """Nearest-index maps replicating scipy.ndimage.rotate(order=0,
    reshape=False, mode='constant') for every integer angle in [-20, 20):
    inverse rotation about the (n-1)/2 center, floor(coord+0.5) indices,
    and scipy's boundary rule (a pixel is cval when the raw source
    coordinate leaves [0, size-1]). Computed in float64 numpy: f32 trig
    would flip pixels that sit on rounding boundaries."""
    ci, cj = (h - 1) / 2.0, (w - 1) / 2.0
    di = np.arange(h, dtype=np.float64)[:, None] - ci
    dj = np.arange(w, dtype=np.float64)[None, :] - cj
    i0s, j0s, valids = [], [], []
    for ang in ROT_ANGLES:
        a = np.deg2rad(float(ang))
        si = np.cos(a) * di + np.sin(a) * dj + ci
        sj = -np.sin(a) * di + np.cos(a) * dj + cj
        i0s.append(np.clip(np.floor(si + 0.5), 0, h - 1).astype(np.int32))
        j0s.append(np.clip(np.floor(sj + 0.5), 0, w - 1).astype(np.int32))
        valids.append((si >= 0) & (si <= h - 1) & (sj >= 0) & (sj <= w - 1))
    return np.stack(i0s), np.stack(j0s), np.stack(valids)


def transform_maps(h: int, w: int):
    """([49, H*W] int32 source index of every output pixel, [49, H*W]
    bool validity) of the 49 transforms, on the host."""
    ident = np.arange(h * w, dtype=np.int32).reshape(h, w)
    maps, valid = [ident.ravel()], [np.ones(h * w, bool)]
    for k in range(4):
        for axis in range(2):
            maps.append(np.flip(np.rot90(ident, k), axis=axis).ravel())
            valid.append(np.ones(h * w, bool))
    i0, j0, ok = _rotate_maps(h, w)
    for a in range(len(ROT_ANGLES)):
        maps.append((i0[a] * w + j0[a]).ravel())
        valid.append(ok[a].ravel())
    return np.stack(maps).astype(np.int32), np.stack(valid)


class DeviceSliceBank:
    """Training slices on the device, transformed by one gather per batch
    (``draw_params`` on the host, ``gather`` on the device)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 device="cuda"):
        if images.shape[1] != images.shape[2]:
            raise ValueError(
                f"output size must be square for device rot90, got "
                f"{images.shape[1:]}")
        self.device = resolve_device(device)
        n, h, w = images.shape
        self.shape = (h, w)
        self.images = torch.from_numpy(
            np.ascontiguousarray(images, np.float32)).reshape(n, h * w) \
            .to(self.device)
        self.labels = torch.from_numpy(
            np.ascontiguousarray(labels, np.int8)).reshape(n, h * w) \
            .to(self.device)
        maps, valid = transform_maps(h, w)
        self.maps = torch.from_numpy(maps).long().to(self.device)
        self.valid = torch.from_numpy(valid).to(self.device)

    def __len__(self):
        return self.images.shape[0]

    @classmethod
    def from_dataset(cls, dataset, device="cuda") -> "DeviceSliceBank":
        """dataset: exposes output_size, __len__ and load(i) -> (image,
        label) numpy (datasets.SliceDataset / SynapseDataset)."""
        from scipy import ndimage
        out = dataset.output_size
        imgs, labs = [], []
        for i in range(len(dataset)):
            image, label = dataset.load(i)
            x, y = image.shape
            if (x, y) != tuple(out):
                image = ndimage.zoom(image, (out[0] / x, out[1] / y),
                                     order=0)
                label = ndimage.zoom(label, (out[0] / x, out[1] / y),
                                     order=0)
            imgs.append(image.astype(np.float32))
            labs.append(label.astype(np.int8))
        return cls(np.stack(imgs), np.stack(labs), device)

    def draw_params(self, rng: np.random.RandomState, idxs) -> np.ndarray:
        """[B, 5] int32 (idx, mode, k, axis, angle); mode 0 = identity, 1 =
        rot90+flip, 2 = nearest rotate. Consumes ``rng`` exactly like
        datasets.random_generator_2d."""
        rows = []
        for i in idxs:
            mode = k = axis = angle = 0
            if rng.random_sample() > 0.5:
                mode = 1
                k = rng.randint(0, 4)
                axis = rng.randint(0, 2)
            elif rng.random_sample() > 0.5:
                mode = 2
                angle = rng.randint(-20, 20)
            rows.append((int(i), mode, k, axis, angle))
        return np.asarray(rows, np.int32)

    def gather(self, params: np.ndarray):
        """[B, 5] int32 -> (images [B, 1, H, W] f32, labels [B, H, W]
        int32), both on the device."""
        p = torch.from_numpy(np.ascontiguousarray(params, np.int32))
        if self.device.type == "cuda":
            p = p.pin_memory()
        p = p.to(self.device, non_blocking=True).long()
        idx, mode, k, axis, angle = p.unbind(1)
        row = torch.where(mode == 0, 0,
                          torch.where(mode == 1, 1 + 2 * k + axis,
                                      1 + _N_ROTFLIP + angle + 20))
        src = self.maps[row]                                  # [B, H*W]
        ok = self.valid[row]
        img = torch.where(ok, self.images[idx].gather(1, src), 0.0)
        lab = torch.where(ok, self.labels[idx].gather(1, src), 0)
        b, (h, w) = p.shape[0], self.shape
        return img.reshape(b, 1, h, w), lab.to(torch.int32).reshape(b, h, w)


class DeviceVolumeBank:
    """Training volumes on the device, rotated, flipped and cropped there
    (``draw_params`` on the host, ``gather`` on the device)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, patch_size,
                 device="cuda"):
        if images.shape[1] != images.shape[2]:
            raise ValueError(
                f"in-plane shape must be square for device rot90, got "
                f"{images.shape[1:]}")
        self.device = resolve_device(device)
        self.patch = tuple(patch_size)
        self.shape = images.shape[1:]
        self.images = torch.from_numpy(
            np.ascontiguousarray(images, np.float32)).to(self.device)
        self.labels = torch.from_numpy(
            np.ascontiguousarray(labels, np.int8)).to(self.device)

    def __len__(self):
        return self.images.shape[0]

    @classmethod
    def from_dataset(cls, dataset, patch_size,
                     device="cuda") -> "DeviceVolumeBank":
        """dataset: exposes __len__ and load(i) -> (image, label) numpy
        [W, H, D] (datasets.LAHeartDataset, InMemoryVolumes)."""
        vols, labs = [], []
        for i in range(len(dataset)):
            img, lab = pad_for_crop_3d(*dataset.load(i), patch_size)
            vols.append(img.astype(np.float32))
            labs.append(lab.astype(np.int8))
        shapes = {v.shape for v in vols}
        if len(shapes) != 1:
            raise ValueError(
                f"device bank needs uniform volume shapes, got {shapes}")
        return cls(np.stack(vols), np.stack(labs), patch_size, device)

    def draw_params(self, rng: np.random.RandomState, idxs) -> np.ndarray:
        """[B, 6] int32 (vol, k, axis, w1, h1, d1). Consumes ``rng`` exactly
        as the host path does (random_rot_flip_3d, then random_crop_3d)."""
        w, h, d = self.shape
        ow, oh, od = self.patch
        rows = []
        for i in idxs:
            k = rng.randint(0, 4)
            axis = rng.randint(0, 2)
            # rot90 in (0, 1) of a square plane keeps (w, h)
            w1 = rng.randint(0, w - ow + 1)
            h1 = rng.randint(0, h - oh + 1)
            d1 = rng.randint(0, d - od + 1)
            rows.append((int(i), k, axis, w1, h1, d1))
        return np.asarray(rows, np.int32)

    def gather(self, params: np.ndarray):
        """[B, 6] int32 -> (images [B, 1, *patch] f32, labels [B, *patch]
        int32), both on the device. The parameters stay on the host: each
        sample is a rot90, a flip and a crop of its staged volume."""
        ow, oh, od = self.patch
        imgs, labs = [], []
        for vol, k, axis, w1, h1, d1 in params.tolist():
            crop = np.s_[w1:w1 + ow, h1:h1 + oh, d1:d1 + od]
            for src, out in ((self.images, imgs), (self.labels, labs)):
                v = torch.flip(torch.rot90(src[vol], k, (0, 1)), (axis,))
                out.append(v[crop])
        return (torch.stack(imgs)[:, None],
                torch.stack(labs).to(torch.int32))


def two_stream_device_batches(bank_l, bank_u, bs_l: int, bs_u: int,
                              seed: int):
    """Endless {image_l, label_l, image_u} batches on the device from two
    slice or volume banks, reproducing TwoStreamPipeline's single-worker
    RandomState stream exactly (worker rng = RandomState(seed + 1000 * 0);
    per batch: labeled indices, unlabeled indices, then the per-sample
    transform draws, labeled first)."""
    rng = np.random.RandomState(seed + 1000 * 0)
    n_l, n_u = len(bank_l), len(bank_u)
    while True:
        li = rng.randint(0, n_l, size=bs_l)
        ui = rng.randint(0, n_u, size=bs_u)
        img_l, lab_l = bank_l.gather(bank_l.draw_params(rng, li))
        img_u, _ = bank_u.gather(bank_u.draw_params(rng, ui))
        yield {"image_l": img_l, "label_l": lab_l, "image_u": img_u}
