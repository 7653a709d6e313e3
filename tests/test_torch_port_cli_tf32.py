"""Every entry point of the port computes its f32 convolutions and matmuls
in f32: after each CLI's ``main`` on a tiny tree (CPU), TF32 is off in
cuDNN and in CUDA matmuls, whatever it was before (torch's default lets
cuDNN convolutions use TF32)."""

import os

import pytest
import torch

from arco_torch.cli import (pretrain_2d, test_2d, test_3d, train_arco_2d,
                            train_arco_3d)
from arco_torch.data.synthetic import make_acdc_like, make_la_like

torch.set_num_threads(1)

SMALL_ARCO = ["--arco.K", "2", "--arco.num_queries", "16",
              "--arco.num_negatives", "8", "--arco.memobank_size", "64",
              "--arco.memobank_size_bg", "64", "--arco.memobank_enqueue",
              "16", "--arco.topk", "2"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("tf32")
    acdc = make_acdc_like(str(base / "ACDC"), n_train=30, n_val=1,
                          size=(32, 32), num_classes=3)
    la = make_la_like(str(base / "LA"), n_train=4, size=(40, 40, 20))
    model_dir = str(base / "model")
    common = ["--device", "cpu", "--snapshot_dir", model_dir,
              "--compute_dtype", "float32", "--batch_size", "2",
              "--labeled_bs", "1", "--max_iterations", "1"] + SMALL_ARCO
    argv = {
        "train_arco_2d": ["--root_path", acdc, "--exp", "ACDC/tf32",
                          "--labeled_num", "1", "--patch_size", "32", "32",
                          "--num_classes", "3"] + common,
        "pretrain_2d": ["--root_path", acdc, "--exp", "ACDC/pre",
                        "--labeled_num", "1", "--patch_size", "32", "32",
                        "--num_classes", "3", "--isd.K", "2",
                        "--isd.latent_feature_size", "32",
                        "--isd.output_pooling_size", "4",
                        "--isd.patch_size", "16"] + common,
        "train_arco_3d": ["--root_path", la, "--exp", "LA/tf32",
                          "--labeled_num", "2", "--patch_size", "32", "32",
                          "16"] + common,
        "test_2d": ["--root_path", acdc, "--exp", "ACDC/tf32",
                    "--labeled_num", "1", "--num_classes", "3",
                    "--snapshot_dir", model_dir, "--input_size", "32", "32",
                    "--device", "cpu"],
        "test_3d": ["--root_path", la, "--exp", "LA/tf32", "--labeled_num",
                    "2", "--snapshot_dir", model_dir, "--patch_size", "32",
                    "32", "16", "--device", "cpu"],
    }
    # the checkpoints the evaluations read
    train_arco_2d.main(argv["train_arco_2d"])
    train_arco_3d.main(argv["train_arco_3d"])
    assert os.path.isdir(os.path.join(model_dir, "LA/tf32_2_labeledfinal",
                                      "vnet", "iter_1"))
    return argv


CLIS = {"train_arco_2d": train_arco_2d, "pretrain_2d": pretrain_2d,
        "train_arco_3d": train_arco_3d, "test_2d": test_2d,
        "test_3d": test_3d}


@pytest.mark.parametrize("name", list(CLIS))
def test_main_leaves_tf32_off(trees, name, tmp_path):
    argv = list(trees[name])
    if name in ("train_arco_2d", "pretrain_2d", "train_arco_3d"):
        argv[argv.index("--snapshot_dir") + 1] = str(tmp_path)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    CLIS[name].main(argv)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
