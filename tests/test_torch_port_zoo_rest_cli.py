"""nnU-Net and VoxResNet through the port's factories and CLIs, against the
JAX package (CPU, f32, TF32 off).

The keys each JAX CLI takes were found by running them on a synthetic
tree at a small size (nnU-Net 2D at 64x64, nnU-Net 3D at 64x64x16,
VoxResNet at 32x32x16, one step or one checkpoint each):
``pretrain_2d`` and ``test_2d`` ran nnUNet; ``train_arco_2d`` failed
building its state (the FeatureExtractor fuses the U-Net's five maps, not
nnU-Net's six); ``pretrain_3d`` and ``test_3d`` ran nnUNet and voxresnet
(nnUNet's test_3d failed at a skip concatenation with a 56x56x16 patch,
off its lattice); ``train_arco_3d`` failed building its state for nnUNet,
voxresnet and unet_3D (its FeatureExtractor and heads take the V-Net's
maps). ``test_jax_forward_structure_3d`` holds the port's table
(models/factory.py:check_model_3d) to JAX's forwards and FeatureExtractor.

Then each new key runs through the port's CLIs at a small size: a
pretrain of 2 steps and an evaluation of its checkpoint; the refusals
raise before any state, naming the model. ``test_2d``'s predictions
(nnUNet) and the 3D sliding-window label maps (voxresnet; nnU-Net's
forward is held in tests/test_torch_port_nnunet.py) of weights carried
from flax equal JAX's wherever the two largest scores lie more than 1e-4
apart.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.eval import sliding_window as jsw
from arco_tpu.models import net_factory as jax_net_factory
from arco_tpu.models import net_factory_3d as jax_net_factory_3d
from arco_tpu.models.heads import FeatureExtractor as JaxFeatureExtractor

from arco_torch.cli import (pretrain_2d, pretrain_3d, test_2d, test_3d,
                            train_arco_2d, train_arco_3d)
from arco_torch.compat.from_flax import model_state_dict_from_flax
from arco_torch.data.synthetic import make_acdc_like, make_la_like
from arco_torch.eval import sliding_window as sw
from arco_torch.models import net_factory, net_factory_3d
from arco_torch.models.factory import FEATURE_MAPS, check_model, \
    check_model_3d

from test_torch_port_zoo2d_cli import \
    test_test_2d_predictions_match_jax as _test_2d_matches_jax
from test_torch_port_zoo_rest import random_variables

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

KEYS_3D = ("vnet", "unet_3D", "unet_3D_dv_semi", "attention_unet",
           "voxresnet", "nnUNet")
TRIPLES_3D = ("vnet", "unet_3D", "attention_unet", "voxresnet", "nnUNet")
# the keys each JAX CLI runs (see the docstring)
JAX_RUNS_3D = {"train_arco_3d": ("vnet",), "pretrain_3d": TRIPLES_3D,
               "test_3d": TRIPLES_3D}
JAX_RUNS_NNUNET_2D = {"train_arco_2d": False, "pretrain_2d": True,
                      "test_2d": True}
SMALL_ISD = ["--isd.K", "4", "--isd.latent_feature_size", "32",
             "--isd.output_pooling_size", "2", "--isd.patch_size", "8"]
# each 3D key's smallest patch (the lattice of nnU-Net is 64x64x4), and a
# volume a little larger, which the sliding window covers with 8 windows
PATCH_3D = {"nnUNet": ("64", "64", "8"), "voxresnet": ("32", "32", "16")}
VOLUME_3D = {"voxresnet": (40, 36, 20)}


# ---------------------------------------------------- which CLI takes what

@pytest.mark.parametrize("cli", sorted(JAX_RUNS_NNUNET_2D))
def test_check_model_takes_nnunet_where_jax_does(cli):
    if JAX_RUNS_NNUNET_2D[cli]:
        check_model("nnUNet", cli)
    else:
        with pytest.raises(ValueError, match=r"'nnUNet' \[480, 256, 128, "
                           r"64, 32, 16\] do not match"):
            check_model("nnUNet", cli)


@pytest.mark.parametrize("cli", sorted(JAX_RUNS_3D))
@pytest.mark.parametrize("key", KEYS_3D)
def test_check_model_3d_takes_the_jax_keys(cli, key):
    if key in JAX_RUNS_3D[cli]:
        check_model_3d(key, cli)
    else:
        with pytest.raises(ValueError, match=f"{cli}: model '{key}'"):
            check_model_3d(key, cli)


def test_check_model_3d_names_unknown_keys():
    with pytest.raises(ValueError, match="'unet_2D' is not a 3D model"):
        check_model_3d("unet_2D", "test_3d")


def _jax_forward(jm, x):
    v = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, train=False))
    return jax.eval_shape(lambda v: jm.apply(
        v, x, train=False, rngs={"dropout": jax.random.PRNGKey(0)}), v)


def _builds(fe, fmap):
    """Whether the JAX FeatureExtractor ``fe`` builds on the maps."""
    try:
        jax.eval_shape(lambda f: fe.init(jax.random.PRNGKey(0), f), fmap)
    except (AssertionError, TypeError, ValueError):  # the maps do not fit
        return False
    return True


@pytest.mark.parametrize("key", KEYS_3D)
def test_jax_forward_structure_3d(key):
    """JAX's forward of each 3D key at 64x64x8: a (logits, latent, maps)
    triple for the keys test_3d and pretrain_3d take, four outputs for
    unet_3D_dv_semi; train_arco_3d's FeatureExtractor (the V-Net's widths)
    builds on the V-Net's maps only; the port's model gives the same
    latent width (``latent_channels``, which the pretrain heads read)."""
    jm = jax_net_factory_3d(key, in_chns=1, class_num=2)
    out = _jax_forward(jm, jnp.zeros((1, 64, 64, 8, 1)))
    if key not in TRIPLES_3D:
        assert len(out) == 4
        return
    assert len(out) == 3
    fmap = out[2]
    fe = JaxFeatureExtractor(fea_dim=(128, 64, 32, 16, 16), output_dim=16)
    assert _builds(fe, fmap) == (key in JAX_RUNS_3D["train_arco_3d"])
    assert net_factory_3d(key).latent_channels == out[1].shape[-1]


def test_jax_forward_structure_nnunet_2d():
    """JAX's nnU-Net 2D gives six maps, the widths FEATURE_MAPS states; the
    ARCO FeatureExtractor does not build on them."""
    jm = jax_net_factory("nnUNet", in_chns=1, class_num=4)
    _, latent, fmap = _jax_forward(jm, jnp.zeros((1, 64, 64, 1)))
    assert tuple(f.shape[-1] for f in fmap) == FEATURE_MAPS["nnUNet"]
    assert not _builds(JaxFeatureExtractor(), fmap)
    assert net_factory("nnUNet").latent_channels == latent.shape[-1]


@pytest.mark.parametrize("cli,key", [
    (train_arco_2d, "nnUNet"), (train_arco_3d, "nnUNet"),
    (train_arco_3d, "voxresnet"), (train_arco_3d, "unet_3D"),
    (pretrain_3d, "unet_3D_dv_semi"), (test_3d, "unet_3D_dv_semi")])
def test_clis_refuse_before_any_state(tmp_path, cli, key):
    with pytest.raises(ValueError, match=f"'{key}'"):
        cli.main(["--device", "cpu", "--model", key, "--snapshot_dir",
                  str(tmp_path)])
    assert not any(tmp_path.iterdir())


# ----------------------------------------------------------- the 2D CLIs

@pytest.fixture(scope="module")
def acdc(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_nnunet")
    make_acdc_like(str(root), n_train=40, n_val=2, size=(64, 64), depth=3)
    return str(root)


def test_pretrain_2d_and_test_2d_run_nnunet(acdc, tmp_path, capsys):
    """pretrain_2d --model nnUNet for 2 steps (the latent head reads the
    480-channel bottleneck), then test_2d on its iter_2."""
    pretrain_2d.main(["--device", "cpu", "--root_path", acdc, "--exp",
                      "ACDC/nn", "--labeled_num", "1", "--model", "nnUNet",
                      "--patch_size", "64", "64", "--batch_size", "4",
                      "--labeled_bs", "2", "--compute_dtype", "float32",
                      "--snapshot_dir", str(tmp_path), "--max_iterations",
                      "2", "--log_every", "1", "--ckpt_every", "2"]
                     + SMALL_ISD)
    snap = os.path.join(str(tmp_path), "ACDC/nn_1_labeledfinal", "nnUNet")
    rows = [json.loads(ln) for ln in open(os.path.join(snap,
                                                       "metrics.jsonl"))]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    capsys.readouterr()
    res = test_2d.main(["--device", "cpu", "--root_path", acdc, "--exp",
                        "ACDC/nn", "--labeled_num", "1", "--model",
                        "nnUNet", "--snapshot_dir", str(tmp_path),
                        "--input_size", "64", "64"])
    assert np.isfinite(res["raw"]).all()
    pc = np.asarray(res["per_class"])
    assert ((pc[:, :2] >= 0) & (pc[:, :2] <= 1)).all()


def test_test_2d_nnunet_predictions_match_jax(acdc, tmp_path):
    _test_2d_matches_jax(acdc, tmp_path, "nnUNet")


# ----------------------------------------------------------- the 3D CLIs

@pytest.fixture(scope="module")
def la(tmp_path_factory):
    base = tmp_path_factory.mktemp("la_zoo")
    return make_la_like(str(base / "LA"), n_train=4, size=(66, 66, 18))


@pytest.mark.parametrize("key", sorted(PATCH_3D))
def test_pretrain_3d_and_test_3d_run(la, tmp_path, key, capsys):
    """pretrain_3d for 2 steps, then test_3d on its iter_2."""
    patch = PATCH_3D[key]
    pretrain_3d.main(["--device", "cpu", "--root_path", la, "--exp",
                      "LA/zoo", "--labeled_num", "2", "--model", key,
                      "--patch_size", *patch, "--batch_size", "2",
                      "--labeled_bs", "1", "--compute_dtype", "float32",
                      "--snapshot_dir", str(tmp_path), "--max_iterations",
                      "2", "--log_every", "1", "--ckpt_every", "2"]
                     + SMALL_ISD)
    snap = os.path.join(str(tmp_path), "LA/zoo_2_labeledfinal", key)
    rows = [json.loads(ln) for ln in open(os.path.join(snap,
                                                       "metrics.jsonl"))]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    capsys.readouterr()
    res = test_3d.main(["--device", "cpu", "--root_path", la, "--exp",
                        "LA/zoo", "--labeled_num", "2", "--model", key,
                        "--snapshot_dir", str(tmp_path), "--patch_size",
                        *patch, "--stride_xy", "32", "--stride_z", "16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["iteration"] == 2 and 0.0 <= line["mean_dice"] <= 1.0
    assert np.isfinite(res["raw"]).all()
    if key == "nnUNet":
        # off the lattice the forward fails, as JAX's does
        with pytest.raises(RuntimeError, match="Sizes of tensors"):
            test_3d.main(["--device", "cpu", "--root_path", la, "--exp",
                          "LA/zoo", "--labeled_num", "2", "--model", key,
                          "--snapshot_dir", str(tmp_path), "--patch_size",
                          "56", "56", "8"])


@pytest.mark.parametrize("key", ["voxresnet"])
def test_sliding_window_labels_match_jax(key):
    """test_3d's case prediction (eval/sliding_window.py) with weights
    carried from flax against JAX's, on one volume of 8 windows."""
    patch = tuple(int(p) for p in PATCH_3D[key])
    jm = jax_net_factory_3d(key, in_chns=1, class_num=2)
    params, stats = random_variables(jm, [jnp.zeros((1,) + patch + (1,))],
                                     {"train": False}, seed=3)
    tm = net_factory_3d(key, in_chns=1, class_num=2)
    tm.load_state_dict(model_state_dict_from_flax(params, stats))
    v = jax.tree_util.tree_map(jnp.asarray, {"params": params})
    apply = jax.jit(lambda x: jax.nn.softmax(
        jm.apply(v, x, train=False)[0], axis=-1))
    image = np.random.RandomState(4).randn(*VOLUME_3D[key]).astype(
        np.float32)
    j_lab, j_score = jsw.test_single_case_3d(apply, image, 16, 8, patch, 2)
    lab, score = sw.test_single_case_3d(sw.model_predictor(tm, "cpu"),
                                        image, 16, 8, patch, 2)
    np.testing.assert_allclose(score, np.asarray(j_score), rtol=0,
                               atol=1e-4)
    top2 = np.sort(np.asarray(j_score), axis=0)[-2:]
    decided = top2[1] - top2[0] > 1e-4
    np.testing.assert_array_equal(lab[decided], np.asarray(j_lab)[decided])
