"""High-level inference API: load a trained snapshot, predict volumes
(counterpart of arco_tpu/inference.py).

    from arco_torch.inference import Segmenter
    seg = Segmenter.from_snapshot("../model/ACDC/arco_7_labeledfinal/unet")
    labels = seg.predict_volume(volume)          # [D, H, W] -> [D, H, W]

Both classes read the port's own iter_<N> checkpoints
(train/checkpoint.py:load_model_params) and run on the card unless given
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from arco_torch import resolve_device
from arco_torch.eval import slice2d, sliding_window
from arco_torch.models import net_factory, net_factory_3d
from arco_torch.train import checkpoint as ckpt


def _snapshot_step(snapshot_dir: str, iteration: Optional[int]) -> int:
    # JAX's `iteration or latest`: iteration 0 also reads the newest
    step = iteration or ckpt.latest_step(snapshot_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {snapshot_dir}")
    return step


class Segmenter:
    """2D slice-protocol segmenter (ACDC/MMWHS/Synapse style)."""

    def __init__(self, model: torch.nn.Module,
                 input_size: Tuple[int, int] = (256, 256),
                 num_classes: int = 4, slice_batch: int = 8, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.input_size = tuple(input_size)
        self.num_classes = num_classes
        self.slice_batch = slice_batch
        self._predict = slice2d.model_predictor(self.model, self.device)

    @classmethod
    def from_snapshot(cls, snapshot_dir: str, net_type: str = "unet",
                      num_classes: int = 4, in_chns: int = 1,
                      iteration: Optional[int] = None, **kwargs):
        step = _snapshot_step(snapshot_dir, iteration)
        model = net_factory(net_type, in_chns=in_chns, class_num=num_classes,
                            img_size=tuple(kwargs.get("input_size",
                                                      (256, 256))))
        model.load_state_dict(ckpt.load_model_params(snapshot_dir, step))
        return cls(model, num_classes=num_classes, **kwargs)

    def predict_slices(self, slices: np.ndarray) -> np.ndarray:
        """[N, H, W] (network-sized) -> [N, H, W] int32 labels."""
        return self._predict(np.ascontiguousarray(
            slices.astype(np.float32)[:, None]))

    def predict_volume(self, volume: np.ndarray) -> np.ndarray:
        """[D, H, W] any size -> labels via the slice-wise zoom protocol."""
        dummy = np.zeros_like(volume, dtype=np.int64)
        _, pred = slice2d.test_single_volume_2d(
            volume, dummy, self._predict, self.num_classes, self.input_size,
            self.slice_batch)
        return pred


class Segmenter3D:
    """3D sliding-window segmenter (LA style). Volumes are [W, H, D] (the
    port's [B, C, X, Y, Z] model layout without B and C)."""

    def __init__(self, model: torch.nn.Module, num_classes: int = 2,
                 patch_size=(112, 112, 80), stride_xy: int = 18,
                 stride_z: int = 4, device_eval: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.num_classes = num_classes
        self.patch_size = tuple(patch_size)
        self.stride_xy = stride_xy
        self.stride_z = stride_z
        self.device_eval = device_eval
        # [B, 1, *S] -> softmax scores [B, K, *S] f32 on the device
        self._probs = sliding_window.model_predictor(self.model, self.device)

    @classmethod
    def from_snapshot(cls, snapshot_dir: str, net_type: str = "vnet",
                      num_classes: int = 2, in_chns: int = 1,
                      iteration: Optional[int] = None, **kwargs):
        step = _snapshot_step(snapshot_dir, iteration)
        model = net_factory_3d(net_type, in_chns=in_chns,
                               class_num=num_classes)
        model.load_state_dict(ckpt.load_model_params(snapshot_dir, step))
        return cls(model, num_classes=num_classes, **kwargs)

    def predict_volume(self, volume: np.ndarray) -> np.ndarray:
        if self.device_eval:
            from arco_torch.eval.sliding_window_device import \
                test_single_case_3d_device
            pred, _ = test_single_case_3d_device(
                self._probs, volume, self.stride_xy, self.stride_z,
                self.patch_size, self.num_classes, device=self.device)
        else:
            pred, _ = sliding_window.test_single_case_3d(
                self._probs, volume, self.stride_xy, self.stride_z,
                self.patch_size, self.num_classes)
        return pred

    def predict_volume_sharded(self, volume: np.ndarray, mesh=None,
                               halo: int = 16, lattice: int = 16,
                               spatial_axis: int = 2) -> np.ndarray:
        """Whole-volume forward with one spatial axis split over the ranks
        of the mesh's "data" axis (parallel/spatial.py): no sliding window
        at all. Every rank calls it with the whole volume and gets the
        whole label map. ``spatial_axis`` counts over the model's
        [1, 1, W, H, D] input (2: the volume's first axis).

        The volume is zero-padded so the sharded axis divides the ranks
        and (local + 2*halo) hits the model's stride lattice; the halo is
        rounded up to half the lattice. For a volume that fits the ranks'
        memory together but not one device's: each rank runs one forward
        over its slab instead of the window grid."""
        from arco_torch.parallel import create_mesh
        from arco_torch.parallel.mesh import axis_rank
        from arco_torch.parallel.spatial import sharded_volume_forward
        mesh = mesh or create_mesh()
        _, n, _ = axis_rank(mesh, "data")
        vol = np.asarray(volume, np.float32)
        x = vol[None, None]                           # [1, 1, W, H, D]
        d = x.shape[spatial_axis]
        # pad so local = D_pad/n is a lattice multiple; then the extended
        # slab is lattice-aligned iff 2*halo is, i.e. halo % (lattice/2) == 0
        unit = n * lattice
        d_pad = -(-max(d, unit) // unit) * unit
        local = d_pad // n
        half = max(lattice // 2, 1)
        h = min(-(-halo // half) * half, local)
        pad = [(0, 0)] * x.ndim
        pad[spatial_axis] = (0, d_pad - d)
        # the UNSHARDED spatial axes must hit the lattice too (real LA
        # volumes are e.g. 141x113 in-plane; the decoder skip concats
        # misalign otherwise)
        orig = x.shape
        for ax in range(2, x.ndim):
            if ax == spatial_axis:
                continue
            size = x.shape[ax]
            pad[ax] = (0, -(-size // lattice) * lattice - size)
        x = np.pad(x, pad)
        call = sharded_volume_forward(self._probs, mesh, halo=h,
                                      spatial_axis=spatial_axis,
                                      lattice=lattice)
        pred = call(torch.from_numpy(x)).argmax(1)[0]
        # crop every padded axis back to the input extent
        slicer = tuple(slice(0, orig[ax]) for ax in range(2, x.ndim))
        return pred[slicer].to(torch.int32).cpu().numpy()
