"""The natural-image branch's data functions and preprocessing of the
PyTorch port against the JAX package (host-only numpy/scipy, CPU):
``class_balanced_idx``, ``geometric_transform`` (the same RandomState
calls in the same order, the same arrays), the class map and colormaps,
``NaturalImageDataset`` over a Pascal and a Cityscapes tree (and its
``subset``), the preprocessing recipes and the two preprocess CLIs' output
trees. Everything is compared exactly.
"""

import glob
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from arco_tpu.cli import preprocess_cityscapes as jpre_city
from arco_tpu.cli import preprocess_pascal as jpre_pascal
from arco_tpu.data import natural as jnat
from arco_tpu.data import preprocessing as jprep

from arco_torch.cli import preprocess_cityscapes as tpre_city
from arco_torch.cli import preprocess_pascal as tpre_pascal
from arco_torch.data import natural as tnat
from arco_torch.data import preprocessing as tprep


# --------------------------------------------------------------------- data

def test_class_balanced_idx():
    rs = np.random.RandomState(0)
    masks = [rs.randint(0, 6, (8, 8)) * (rs.rand(8, 8) > 0.6)
             for _ in range(30)]
    for label_num, min_px in ((1, 0), (3, 2), (5, 0)):
        want = jnat.class_balanced_idx(masks.__getitem__, range(30), 6,
                                       label_num, seed=4, min_pixels=min_px)
        got = tnat.class_balanced_idx(masks.__getitem__, range(30), 6,
                                      label_num, seed=4, min_pixels=min_px)
        assert got == want


@pytest.mark.parametrize("shape,crop,scale,aug", [
    ((50, 40), (33, 33), (0.5, 1.5), True),
    ((30, 70), (48, 48), (0.5, 1.5), True),
    ((64, 64), (32, 32), (1.0, 1.0), False)])
def test_geometric_transform(shape, crop, scale, aug):
    rs = np.random.RandomState(2)
    image = rs.rand(*shape, 3).astype(np.float32)
    label = rs.randint(0, 5, shape).astype(np.int32)
    for seed in range(4):
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        want = jnat.geometric_transform(rj, image, label, crop, scale, aug)
        got = tnat.geometric_transform(rt, image, label, crop, scale, aug)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # the same number of draws: the streams stay in step
        assert rt.randint(1 << 30) == rj.randint(1 << 30)


def test_cityscapes_class_map_and_colormaps():
    ids = np.arange(36).reshape(6, 6).astype(np.int32)
    np.testing.assert_array_equal(tnat.cityscapes_class_map(ids),
                                  jnat.cityscapes_class_map(ids))
    np.testing.assert_array_equal(tnat.create_pascal_label_colormap(),
                                  jnat.create_pascal_label_colormap())
    np.testing.assert_array_equal(tnat.create_cityscapes_label_colormap(),
                                  jnat.create_cityscapes_label_colormap())
    np.testing.assert_array_equal(tnat.IMAGENET_MEAN, jnat.IMAGENET_MEAN)
    np.testing.assert_array_equal(tnat.IMAGENET_STD, jnat.IMAGENET_STD)
    assert tnat.NaturalImageDataset.DEFAULTS == \
        jnat.NaturalImageDataset.DEFAULTS


def _write_tree(root, dataset):
    """A tiny Pascal or Cityscapes tree: 3 train + 2 val images."""
    rs = np.random.RandomState(7)
    names = {}
    for split, n in (("train", 3), ("val", 2)):
        names[split] = []
        for i in range(n):
            img = rs.randint(0, 255, (40, 52, 3)).astype(np.uint8)
            if dataset == "pascal":
                lab = rs.randint(0, 21, (40, 52)).astype(np.uint8)
                lab[:4] = 255
                name = f"{split}_{i}"
                os.makedirs(root / "JPEGImages", exist_ok=True)
                os.makedirs(root / "SegmentationClassAug", exist_ok=True)
                Image.fromarray(img).save(root / "JPEGImages" / f"{name}.jpg")
                Image.fromarray(lab).save(
                    root / "SegmentationClassAug" / f"{name}.png")
            else:
                lab = rs.randint(0, 34, (40, 52)).astype(np.uint8)
                name = f"city{i % 2}/c_{i}_leftImg8bit.png"
                for kind, arr, fn in (
                        ("images", img, name),
                        ("labels", lab, name.replace("leftImg8bit",
                                                     "gtFine_labelIds"))):
                    path = root / kind / split / fn
                    os.makedirs(path.parent, exist_ok=True)
                    Image.fromarray(arr).save(path)
            names[split].append(name)
    if dataset == "pascal":
        sets = root / "ImageSets" / "Segmentation"
        os.makedirs(sets, exist_ok=True)
        for split, ns in names.items():
            (sets / f"{split}.txt").write_text("\n".join(ns) + "\n")


@pytest.mark.parametrize("dataset", ["pascal", "cityscapes"])
def test_dataset_samples(tmp_path, dataset):
    _write_tree(tmp_path, dataset)
    for split in ("train", "val"):
        jd = jnat.NaturalImageDataset(str(tmp_path), dataset, split,
                                      crop_size=(33, 33))
        td = tnat.NaturalImageDataset(str(tmp_path), dataset, split,
                                      crop_size=(33, 33))
        assert td.idx_list == jd.idx_list and len(td) == len(jd)
        rj, rt = np.random.RandomState(1), np.random.RandomState(1)
        for i in range(len(td)):
            a, b = jd.get(i, rj), td.get(i, rt)
            np.testing.assert_array_equal(b["image"], a["image"])
            np.testing.assert_array_equal(b["label"], a["label"])
            assert b["label"].min() >= -1
        sub = td.subset([1, 0])
        assert sub.idx_list == [td.idx_list[1], td.idx_list[0]]
        s1 = sub.get(0, np.random.RandomState(3))
        s2 = td.get(1, np.random.RandomState(3))
        np.testing.assert_array_equal(s1["image"], s2["image"])


def test_read_without_pil_names_pil(tmp_path, monkeypatch):
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        tnat.read_image(str(tmp_path / "x.png"))


# ------------------------------------------------------------ preprocessing

def test_preprocessing_functions():
    rs = np.random.RandomState(0)
    vol = rs.randn(6, 7, 5).astype(np.float32) * 300
    np.testing.assert_array_equal(tprep.ct_window_normalize(vol),
                                  jprep.ct_window_normalize(vol))
    np.testing.assert_array_equal(tprep.mri_percentile_clip(vol),
                                  jprep.mri_percentile_clip(vol))
    label = rs.randint(0, 4, (30, 30)).astype(np.uint8)
    label[:3] = 255
    for frac in (0.0, 0.05, 0.25):
        want = jprep.partial_label_mask(label, frac,
                                        rng=np.random.RandomState(2))
        got = tprep.partial_label_mask(label, frac,
                                       rng=np.random.RandomState(2))
        np.testing.assert_array_equal(got, want)
    img = rs.rand(20, 30, 3).astype(np.float32)
    lab = rs.randint(0, 19, (20, 30))
    for g, w in zip(tprep.resize_cityscapes_pair(img, lab, (16, 32)),
                    jprep.resize_cityscapes_pair(img, lab, (16, 32))):
        np.testing.assert_array_equal(g, w)


def _tree_files(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**", "*.png"),
                                     recursive=True))


def _same_trees(a, b):
    files = _tree_files(a)
    assert files == _tree_files(b) and files
    for f in files:
        np.testing.assert_array_equal(np.asarray(Image.open(b / f)),
                                      np.asarray(Image.open(a / f)), f)


def test_preprocess_pascal_tree(tmp_path):
    rs = np.random.RandomState(1)
    for side in ("jax", "port"):
        d = tmp_path / side / "SegmentationClassAug"
        os.makedirs(d)
    for i in range(3):
        lab = rs.randint(0, 5, (24, 24)).astype(np.uint8)
        lab[:2] = 255
        for side in ("jax", "port"):
            Image.fromarray(lab).save(
                tmp_path / side / "SegmentationClassAug" / f"im{i}.png")
    jpre_pascal.main(["--label-root",
                      str(tmp_path / "jax" / "SegmentationClassAug"),
                      "--seeds", "0", "1", "--percents", "25", "5"])
    tpre_pascal.main(["--label-root",
                      str(tmp_path / "port" / "SegmentationClassAug"),
                      "--seeds", "0", "1", "--percents", "25", "5"])
    _same_trees(tmp_path / "jax", tmp_path / "port")


def test_preprocess_cityscapes_tree(tmp_path):
    rs = np.random.RandomState(2)
    src = tmp_path / "src"
    for split in ("train", "val"):
        for city in ("aachen", "bonn"):
            for i in range(2):
                stem = f"{city}_{i}"
                p = src / "leftImg8bit" / split / city
                os.makedirs(p, exist_ok=True)
                Image.fromarray(rs.randint(0, 255, (20, 40, 3)).astype(
                    np.uint8)).save(p / f"{stem}_leftImg8bit.png")
                p = src / "gtFine" / split / city
                os.makedirs(p, exist_ok=True)
                # raw ids: void 0, road 7, car 26 (a few classes, so the
                # partial masks grow over 1024x512 in a few dilations)
                ids = np.array([0, 7, 26], np.uint8)
                Image.fromarray(ids[rs.randint(0, 3, (20, 40))]).save(
                    p / f"{stem}_gtFine_labelIds.png")
    for side in ("jax", "port"):
        shutil.copytree(src, tmp_path / side)
    args = ["--seeds", "0", "--percents", "1"]
    jpre_city.main(["--root", str(tmp_path / "jax")] + args)
    tpre_city.main(["--root", str(tmp_path / "port")] + args)
    _same_trees(tmp_path / "jax", tmp_path / "port")
    assert len(os.listdir(tmp_path / "port" / "images" / "train")) == 4
