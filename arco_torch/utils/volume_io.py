"""Prediction volume output (counterpart of arco_tpu/utils/volume_io.py, a
copy).

The reference writes .nii.gz via SimpleITK (test_2D.py:93-101,
test_util.py:64-66). Volumes are written as .nii.gz when nibabel is
importable, otherwise as compressed .npz with the same (1, 1, 10) spacing
metadata recorded.
"""

from __future__ import annotations

import numpy as np

try:
    import nibabel as nib
except ImportError:  # pragma: no cover
    nib = None

SPACING = (1.0, 1.0, 10.0)  # test_2D.py:95


def save_volume(path_base: str, volume: np.ndarray, spacing=SPACING):
    volume = np.asarray(volume).astype(np.float32)
    if nib is not None:
        affine = np.diag(list(spacing) + [1.0])
        nib.save(nib.Nifti1Image(volume, affine), path_base + ".nii.gz")
    else:
        np.savez_compressed(path_base + ".npz", volume=volume,
                            spacing=np.asarray(spacing))


def load_volume(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)["volume"]
    if nib is not None:
        return np.asarray(nib.load(path).dataobj)
    raise ValueError(f"cannot load {path}: nibabel unavailable")
