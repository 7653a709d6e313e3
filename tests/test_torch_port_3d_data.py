"""The port's 3D data path against the JAX package's, bit for bit, on a
``make_la_like`` tree of 48x48x32 volumes (h5) with 32x32x16 patches:
the synthetic tree itself, the LA transforms (rot90 + flip, pad and crop),
``LAHeartDataset`` batches through the host pipeline, ``DeviceVolumeBank``
(on CPU tensors here; tests/test_torch_port_cuda.py runs it on the card)
and ``two_stream_device_batches`` over two volume banks.
"""

import numpy as np
import pytest
import torch

from arco_tpu.data import datasets as jdatasets
from arco_tpu.data import device_bank as jbank
from arco_tpu.data import pipeline as jpipeline
from arco_tpu.data import synthetic as jsynthetic

from arco_torch.data import datasets, device_bank, pipeline, synthetic

PATCH = (32, 32, 16)


@pytest.fixture(scope="module")
def la_root(tmp_path_factory):
    base = tmp_path_factory.mktemp("la3d")
    root = synthetic.make_la_like(str(base / "port"), n_train=6,
                                  size=(48, 48, 32), seed=3)
    jroot = jsynthetic.make_la_like(str(base / "jax"), n_train=6,
                                    size=(48, 48, 32), seed=3)
    return root, jroot


def _split(root, pkg, label_type, patch=PATCH):
    return pkg.LAHeartDataset(root, "train", index=2, label_type=label_type,
                              patch_size=patch)


def test_make_la_like_writes_the_jax_tree(la_root):
    root, jroot = la_root
    for split in ("train", "test"):
        ds = datasets.LAHeartDataset(root, split)
        jds = jdatasets.LAHeartDataset(jroot, split)
        assert ds.sample_list == jds.sample_list
        for i in range(len(ds)):
            for a, b in zip(ds.load(i), jds.load(i)):
                np.testing.assert_array_equal(a, b)
    assert len(datasets.LAHeartDataset(root, "test")) == 2


@pytest.mark.parametrize("size", [(48, 48, 32), (30, 30, 12)])
def test_la_transforms(size):
    """rot90 + flip, then crop; the second size is smaller than the patch
    in every dim, so the pad rule runs too."""
    rs = np.random.RandomState(4)
    image = rs.randn(*size).astype(np.float32)
    label = rs.randint(0, 2, size).astype(np.uint8)
    for seed in range(4):
        got = datasets.random_crop_3d(
            np.random.RandomState(seed), *datasets.random_rot_flip_3d(
                np.random.RandomState(seed + 10), image, label), PATCH)
        want = jdatasets.random_crop_3d(
            np.random.RandomState(seed), *jdatasets.random_rot_flip_3d(
                np.random.RandomState(seed + 10), image, label), PATCH)
        for a, b in zip(got, want):
            assert a.shape == PATCH
            np.testing.assert_array_equal(a, b)


def test_host_pipeline_batches_equal_jax(la_root):
    """LAHeartDataset through TwoStreamPipeline, bs 2 + 2, seed 5: the
    port's first three batches are JAX's."""
    root, jroot = la_root
    port = pipeline.TwoStreamPipeline(
        _split(root, datasets, 1), _split(root, datasets, 0), 4, seed=5,
        labeled_bs=2)
    jax_ = jpipeline.TwoStreamPipeline(
        _split(jroot, jdatasets, 1), _split(jroot, jdatasets, 0), 4, seed=5,
        labeled_bs=2)
    try:
        for _ in range(3):
            got, want = next(port), next(jax_)
            for k in ("image_l", "label_l", "image_u"):
                np.testing.assert_array_equal(got[k], want[k])
            assert got["image_l"].shape == (2,) + PATCH + (1,)
    finally:
        port.close()
        jax_.close()


@pytest.mark.parametrize("patch", [PATCH, (48, 48, 34)])
def test_device_volume_bank_equals_jax_and_the_host_path(la_root, patch):
    """Same draws, same RandomState consumption, same crops; the second
    patch makes the bank pad every volume at staging."""
    root, jroot = la_root
    ds = _split(root, datasets, 0, patch)
    bank = device_bank.DeviceVolumeBank.from_dataset(ds, patch, "cpu")
    jb = jbank.DeviceVolumeBank.from_dataset(_split(jroot, jdatasets, 0,
                                                    patch), patch)
    assert bank.shape == jb.shape
    idxs = [0, 3, 1, 2, 0, 3]
    rng, jrng, host_rng = (np.random.RandomState(11) for _ in range(3))
    params = bank.draw_params(rng, idxs)
    np.testing.assert_array_equal(params, jb.draw_params(jrng, idxs))
    img, lab = bank.gather(params)
    jimg, jlab = jb.gather(params)
    assert img.shape == (len(idxs), 1) + patch and lab.dtype == torch.int32
    np.testing.assert_array_equal(img.movedim(1, -1).numpy(),
                                  np.asarray(jimg))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    host = [ds.get(i, host_rng) for i in idxs]
    np.testing.assert_array_equal(img[:, 0].numpy(),
                                  np.stack([s["image"][..., 0]
                                            for s in host]))
    assert rng.randint(1 << 30) == host_rng.randint(1 << 30)


def test_two_stream_device_batches_equal_jax(la_root):
    root, jroot = la_root
    banks = [device_bank.DeviceVolumeBank.from_dataset(
        _split(root, datasets, t), PATCH, "cpu") for t in (1, 0)]
    jbanks = [jbank.DeviceVolumeBank.from_dataset(
        _split(jroot, jdatasets, t), PATCH) for t in (1, 0)]
    gen = device_bank.two_stream_device_batches(*banks, 2, 2, seed=5)
    jgen = jbank.two_stream_device_batches(*jbanks, 2, 2, seed=5)
    for _ in range(3):
        got, want = next(gen), next(jgen)
        np.testing.assert_array_equal(got["image_l"].movedim(1, -1).numpy(),
                                      np.asarray(want["image_l"]))
        np.testing.assert_array_equal(got["image_u"].movedim(1, -1).numpy(),
                                      np.asarray(want["image_u"]))
        np.testing.assert_array_equal(got["label_l"].numpy(),
                                      np.asarray(want["label_l"]))


def test_in_memory_volumes_are_the_h5_dataset(la_root):
    root, _ = la_root
    ds = _split(root, datasets, 0)
    mem = datasets.InMemoryVolumes([ds.load(i) for i in range(len(ds))],
                                   PATCH)
    assert len(mem) == len(ds)
    a = mem.get(2, np.random.RandomState(1))
    b = ds.get(2, np.random.RandomState(1))
    for k in ("image", "label"):
        np.testing.assert_array_equal(a[k], b[k])


def test_volume_bank_refuses_what_rot90_would_reshape():
    with pytest.raises(ValueError, match="square"):
        device_bank.DeviceVolumeBank(np.zeros((1, 8, 6, 4), np.float32),
                                     np.zeros((1, 8, 6, 4), np.int8),
                                     (4, 4, 4), "cpu")
    ds = datasets.InMemoryVolumes(
        [(np.zeros(s, np.float32), np.zeros(s, np.uint8))
         for s in ((40, 40, 20), (40, 40, 24))], PATCH)
    with pytest.raises(ValueError, match="uniform"):
        device_bank.DeviceVolumeBank.from_dataset(ds, PATCH, "cpu")
