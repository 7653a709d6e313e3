"""The port's natural-image CLIs on the CPU over the JAX suite's fixture
(tests/test_cli_natural.py: a Pascal-layout tree of 8 train and 2 val
48x48 images whose quadrant labels cover classes 0..3): crop 32 (U-Net) or
33 (DeepLab-v2 / ResNet-50), 4 classes, bs 2, K=2 and small banks.

- ``train_arco_natural`` trains, logs every step and writes iter_<N> and
  full_iter_<N> where JAX does; DeepLab-v2's BatchNorm scales and biases
  stay at their initial values (apply_deeplab_bn_freeze);
- ``--resume_snapshot`` seeds the model from another run's newest iter_<N>,
  ``--restore_from`` copies a ``module.``-prefixed torch state dict by name
  and shape, and the two together are refused, as in JAX;
- both CLIs default to the card and raise without one, and leave TF32
  off; the U-Net at a crop not divisible by 16 is refused (JAX's fails at
  its init);
- ``eval_natural`` of one set of weights (seeded, of flax's shapes, carried
  across by compat/from_flax.py) prints the same JSON line as JAX's
  ``eval_natural`` of the same weights: the same iteration, per-class IoU
  and mIoU (both in f32 with the same argmax; compared to 1e-12).
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from arco_tpu.cli import eval_natural as jax_eval_natural
from arco_tpu.models import net_factory as jax_net_factory
from arco_tpu.models.deeplab import model_generator as jax_model_generator

from arco_torch.cli import eval_natural, train_arco_natural
from arco_torch.compat import from_flax
from arco_torch.models.deeplab import DeepLabV2
from arco_torch.train import checkpoint as ckpt

from test_torch_port_zoo2d import random_variables

torch.set_num_threads(1)

SMALL_ARCO = ["--set", "K=2", "--set", "memobank_size=64",
              "--set", "memobank_size_bg=64", "--set", "memobank_enqueue=16",
              "--set", "num_queries=16", "--set", "num_negatives=8",
              "--set", "topk=2"]


@pytest.fixture(scope="module")
def pascal_root(tmp_path_factory):
    """tests/test_cli_natural.py's fixture."""
    root = tmp_path_factory.mktemp("pascal")
    (root / "JPEGImages").mkdir()
    (root / "SegmentationClassAug").mkdir()
    sets = root / "ImageSets" / "Segmentation"
    sets.mkdir(parents=True)
    rng = np.random.RandomState(0)
    names = {"train": [f"tr_{i}" for i in range(8)],
             "val": [f"va_{i}" for i in range(2)]}
    for split, ns in names.items():
        with open(sets / f"{split}.txt", "w") as f:
            f.write("\n".join(ns) + "\n")
        for n in ns:
            lab = np.zeros((48, 48), np.uint8)
            lab[24:, :24], lab[:24, 24:], lab[24:, 24:] = 1, 2, 3
            img = (lab[..., None] * 60 + rng.randint(0, 40, (48, 48, 3))
                   ).astype(np.uint8)
            Image.fromarray(img).save(root / "JPEGImages" / f"{n}.jpg")
            Image.fromarray(lab).save(
                root / "SegmentationClassAug" / f"{n}.png")
    return str(root)


def _common(root, snap, exp, model, crop, backbone="resnet50"):
    return ["--root_path", root, "--dataset", "pascal", "--label_num", "2",
            "--snapshot_dir", str(snap), "--exp", exp, "--crop_size",
            str(crop), "--num_classes", "4", "--model", model,
            "--backbone", backbone]


def _train(common, iterations, ckpt_every=2, extra=()):
    return train_arco_natural.main(
        common + ["--device", "cpu", "--batch_size", "2", "--max_iterations",
                  str(iterations), "--ckpt_every", str(ckpt_every),
                  "--log_every", "1", *extra] + SMALL_ARCO)


def _rows(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_unet_checkpoints_and_eval(pascal_root, tmp_path):
    common = _common(pascal_root, tmp_path, "natural/smoke", "unet", 32)
    run = _train(common, 3)
    assert sorted(d for d in os.listdir(run) if "iter_" in d) == \
        ["full_iter_2", "full_iter_3", "iter_2", "iter_3"]
    rows = _rows(run)
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in rows for k in r)
    log = open(os.path.join(run, "log.txt")).read()
    assert "pascal: 2 labeled + 6 unlabeled images" in log
    res = eval_natural.main(common + ["--device", "cpu"])
    assert res["iteration"] == 3 and len(res["per_class_iou"]) == 4
    assert 0.0 <= res["miou"] <= 1.0


def test_train_deeplabv2_freezes_batchnorm(pascal_root, tmp_path):
    common = _common(pascal_root, tmp_path, "natural/dl", "deeplabv2", 33)
    run = _train(common, 2)
    torch.manual_seed(1337)                 # the CLI's default --seed
    init = DeepLabV2(4, (3, 4, 6, 3)).state_dict()
    after = ckpt.load_model_params(run, 2)
    bn = [k for k in init if ("bn" in k or "downsample.1" in k)
          and k.rsplit(".", 1)[1] in ("weight", "bias")]
    assert len(bn) == 2 * 53                # ResNet-50's BatchNorms
    for k in bn:
        assert torch.equal(after[k], init[k]), k
    assert not torch.equal(after["conv1.weight"], init["conv1.weight"])
    assert not torch.equal(after["bn1.running_mean"],
                           init["bn1.running_mean"])
    assert all(np.isfinite(r["loss"]) for r in _rows(run))


def test_resume_snapshot_and_restore_from(pascal_root, tmp_path):
    first = _train(_common(pascal_root, tmp_path, "natural/a", "unet", 32),
                   2)
    run = _train(_common(pascal_root, tmp_path, "natural/b", "unet", 32), 1,
                 extra=["--resume_snapshot", first])
    assert f"initialized model from {first} iter_2" in \
        open(os.path.join(run, "log.txt")).read()

    torch.manual_seed(0)
    src = DeepLabV2(7, (3, 4, 6, 3)).state_dict()
    path = tmp_path / "trunk.pth"
    torch.save({f"module.{k}": v for k, v in src.items()}, path)
    common = _common(pascal_root, tmp_path, "natural/r", "deeplabv2", 33)
    run = _train(common, 1, extra=["--restore_from", str(path)])
    n_trunk = sum(1 for k in src if not k.startswith("layer5")
                  and not k.endswith("num_batches_tracked"))
    assert f"restored DeepLab trunk from {path} ({n_trunk} tensors)" in \
        open(os.path.join(run, "log.txt")).read()
    with pytest.raises(SystemExit, match="both set"):
        _train(common, 1, extra=["--restore_from", str(path),
                                 "--resume_snapshot", first])


def test_refusals(pascal_root, tmp_path):
    common = _common(pascal_root, tmp_path, "natural/x", "unet", 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            train_arco_natural.main(common)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            eval_natural.main(common)
    with pytest.raises(ValueError, match="divisible by 16"):
        _train(_common(pascal_root, tmp_path, "natural/x", "unet", 33), 1)
    with pytest.raises(SystemExit):
        train_arco_natural.main(common + ["--model", "unet_stego"])


@pytest.mark.parametrize("model,crop", [("unet", 32), ("deeplabv2", 33)])
def test_eval_matches_jax(pascal_root, tmp_path, monkeypatch, model, crop):
    common = _common(pascal_root, tmp_path, "natural/ev", model, crop)
    if model == "unet":
        jmodel = jax_net_factory("unet", in_chns=3, class_num=4)
    else:
        jmodel = jax_model_generator(model, "resnet50", num_classes=4)
    params, stats = random_variables(jmodel, jnp.zeros((1, crop, crop, 3)),
                                     seed=3)
    monkeypatch.setattr(jax_eval_natural.ckpt, "load_model_params",
                        lambda *a: (params, stats))
    monkeypatch.setattr(jax_eval_natural.ckpt, "latest_step", lambda d: 5)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_eval_natural.main(common)
    want = json.loads(out.getvalue().strip().splitlines()[-1])

    snap = os.path.join(tmp_path, "natural/ev_2_labeled", model)
    ckpt._save(ckpt._path(snap, 5), {
        "step": 5,
        "model": from_flax.model_state_dict_from_flax(params, stats)})
    with contextlib.redirect_stdout(io.StringIO()):
        got = eval_natural.main(common + ["--device", "cpu"])
    assert set(got) == set(want) == {"iteration", "miou", "per_class_iou"}
    assert got["iteration"] == want["iteration"] == 5
    np.testing.assert_allclose(got["per_class_iou"], want["per_class_iou"],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["miou"], want["miou"], rtol=0,
                               atol=1e-12)
    assert 0 < got["miou"] < 1


def test_mains_leave_tf32_off(pascal_root, tmp_path):
    """Both CLIs compute their f32 convolutions and matmuls in f32, as
    every entry point of the port does (test_torch_port_cli_tf32.py)."""
    common = _common(pascal_root, tmp_path, "natural/tf32", "unet", 32)
    for run in (lambda: _train(common, 1, ckpt_every=1),
                lambda: eval_natural.main(common + ["--device", "cpu"])):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with contextlib.redirect_stdout(io.StringIO()):
            run()
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
