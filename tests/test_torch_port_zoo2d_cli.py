"""The 2D zoo through the port's factory and CLIs, against the JAX package
(CPU, f32, TF32 off).

- ``net_factory`` builds the ten zoo keys and (since the rest of the zoo)
  ``nnUNet``; an unknown key raises.
- Each port CLI takes exactly the keys its JAX counterpart runs and
  refuses the others before it builds any state, with a message naming
  the model and why. The JAX CLIs' keys were found by running them (each
  key, one step at 64x64 on a synthetic ACDC tree, ``python -m
  arco_tpu.cli.pretrain_2d`` / ``train_arco_2d --model <key>``):
  ``pretrain_2d`` ran unet and the six 3-tuple models (unet_stego, enet,
  pnet, efficient_unet, ViT_Seg, swin_unet) and failed on the four-output
  variants (unpacking their outputs); ``train_arco_2d`` ran unet and
  unet_stego only (the others fail building the FeatureExtractor or
  unpacking); JAX's ``test_2d`` unpacks ``logits, _, _ = model.apply(...)``,
  which the same seven keys satisfy. ``test_jax_forward_structure`` reads
  the forwards' structure from JAX (``jax.eval_shape``) and holds the
  port's table of feature maps (models/factory.py) to it.
- ``test_2d``'s predictions for the six zoo keys it evaluates against JAX's
  prediction (``model.apply(..., train=False)``, argmax) with the same
  weights, case by case.
- One stage-2 step with ``unet_stego`` at 32x32 against JAX's
  ``make_arco_step``: the slice as a whole.
- ``compat/swin_config.py``'s yaml recipe against JAX's, with a BASE chain
  and ``opts``.

Tolerances: predictions equal pixel for pixel except where the two
largest logits lie within 1e-4 of each other; the step's, stated above
``test_stego_step_loss_terms``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.compat import swin_config as jswin_config
from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.data.datasets import SliceDataset as JaxSliceDataset
from arco_tpu.eval.slice2d import test_single_volume_2d as jax_test_volume
from arco_tpu.models import net_factory as jax_net_factory
from arco_tpu.models.heads import FeatureExtractor as JaxFeatureExtractor
from arco_tpu.train import arco2d as jax_arco2d
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.augment.tps import RandTPS
from arco_torch.cli import pretrain_2d, test_2d, train_arco_2d
from arco_torch.compat import swin_config
from arco_torch.compat.from_flax import (
    feature_extractor_state_dict_from_flax, head_state_dict_from_flax,
    load_flax_arco_state, model_state_dict_from_flax,
    unet_stego_state_dict_from_flax)
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.data.synthetic import make_acdc_like
from arco_torch.models import net_factory
from arco_torch.models.factory import FEATURE_MAPS, check_model
from arco_torch.models.swin_unet import SwinUnet
from arco_torch.models.unet2d_variants import UNetSTEGO
from arco_torch.train import arco2d
from arco_torch.train import checkpoint as ckpt

from test_torch_port_step import (B, CFG, HW, LOSS_TOL, NC, STATE_TOL, TERMS,
                                  _assert_module, _batch, _draws,
                                  _FixedGridTPS, _flax_state_numpy)
from test_torch_port_zoo2d import (port_masks, random_variables,
                                   recording)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

ZOO = ("unet_stego", "unet_har", "unet_ds", "unet_cct", "unet_urpc", "pnet",
       "enet", "efficient_unet", "ViT_Seg", "swin_unet")
THREE_TUPLE = ("unet", "unet_stego", "enet", "pnet", "efficient_unet",
               "ViT_Seg", "swin_unet")
# the keys each JAX CLI runs (found by running them, see the docstring)
JAX_RUNS = {"train_arco_2d": ("unet", "unet_stego"),
            "pretrain_2d": THREE_TUPLE, "test_2d": THREE_TUPLE}


# ------------------------------------------------------------- factory

@pytest.mark.parametrize("key", ZOO)
def test_net_factory_builds_the_zoo(key):
    torch.manual_seed(0)
    model = net_factory(key, in_chns=1, class_num=3, img_size=64)
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, 1, 64, 64))
    assert out[0].shape == (1, 3, 64, 64)
    assert len(out) == (3 if key in THREE_TUPLE else 4)


def test_net_factory_nnunet_still_raises():
    """nnUNet (since the rest of the zoo) builds the 2D GenericUNet; a key
    no factory knows still raises."""
    from arco_torch.models.nnunet import GenericUNet
    model = net_factory("nnUNet", class_num=3)
    assert isinstance(model, GenericUNet)
    assert (model.spatial_dims, model.latent_channels) == (2, 480)
    with pytest.raises(NotImplementedError, match="'nnUNet3d' is not a 2D"):
        net_factory("nnUNet3d")


@pytest.mark.parametrize("key", ("unet",) + ZOO)
def test_jax_forward_structure(key):
    """JAX's forward of each key (eval_shape at 64x64): the output count,
    and the widths of the feature maps, which the port's FEATURE_MAPS
    table (and so check_model) states; the ARCO FeatureExtractor builds
    on the U-Net's maps only."""
    jm = jax_net_factory(key, in_chns=1, class_num=4)
    x = jnp.zeros((1, 64, 64, 1))
    out = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
         "perturb": jax.random.PRNGKey(0)}, x, train=False))
    out = jax.eval_shape(lambda v: jm.apply(
        v, x, train=False, rngs={"dropout": jax.random.PRNGKey(0)}), out)
    if FEATURE_MAPS[key] is None:
        assert len(out) == 4
        return
    assert len(out) == 3
    widths = tuple(f.shape[-1] for f in out[2])
    assert widths == FEATURE_MAPS[key]
    fe = JaxFeatureExtractor()
    try:
        jax.eval_shape(lambda f: fe.init(jax.random.PRNGKey(0), f), out[2])
        builds = True
    except (AssertionError, TypeError, ValueError):  # the maps do not fit
        builds = False
    assert builds == (key in JAX_RUNS["train_arco_2d"])


@pytest.mark.parametrize("cli", sorted(JAX_RUNS))
@pytest.mark.parametrize("key", ("unet",) + ZOO)
def test_check_model_takes_the_jax_keys(cli, key):
    if key in JAX_RUNS[cli]:
        check_model(key, cli)
    else:
        with pytest.raises(ValueError, match=key):
            check_model(key, cli)


def test_refusals_name_the_reason():
    with pytest.raises(ValueError, match=r"\[128, 64, 16\] do not match "
                       r"the ARCO FeatureExtractor's \(256, 128, 64, 32, "
                       r"16\)"):
        check_model("enet", "train_arco_2d")
    with pytest.raises(ValueError, match="returns four values"):
        check_model("unet_cct", "test_2d")


@pytest.mark.parametrize("key", ("enet", "unet_ds", "swin_unet"))
def test_train_cli_refuses_before_any_state(tmp_path, key):
    """train_arco_2d raises before it makes its snapshot directory."""
    with pytest.raises(ValueError, match=key):
        train_arco_2d.main(["--device", "cpu", "--model", key,
                            "--snapshot_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("key", ("unet_har", "unet_urpc"))
def test_pretrain_and_test_cli_refuse_the_variants(tmp_path, key):
    with pytest.raises(ValueError, match=key):
        pretrain_2d.main(["--device", "cpu", "--model", key,
                          "--snapshot_dir", str(tmp_path)])
    with pytest.raises(ValueError, match=key):
        test_2d.main(["--device", "cpu", "--model", key,
                      "--snapshot_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_freeze_flags_reach_the_unet_only():
    """JAX's freeze labels cannot classify UNetSTEGO's inlined decoder;
    the port refuses it too."""
    from arco_torch.train import freeze
    with pytest.raises(ValueError, match="UNetSTEGO"):
        freeze.apply_freeze(UNetSTEGO(class_num=4), True, False)


# ------------------------------------------------------------- test_2d

EVAL_KEYS = ("unet_stego", "enet", "pnet", "efficient_unet", "ViT_Seg",
             "swin_unet")


@pytest.fixture(scope="module")
def acdc(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc")
    make_acdc_like(str(root), n_train=4, n_val=2, size=(64, 64), depth=3)
    return str(root)


@pytest.mark.parametrize("key", EVAL_KEYS)
def test_test_2d_predictions_match_jax(acdc, tmp_path, key):
    """The port's test_2d (--save_predictions) on a checkpoint of random
    weights carried from flax, against JAX's prediction of each slice."""
    jm = jax_net_factory(key, in_chns=1, class_num=4)
    params, stats = random_variables(jm, jnp.zeros((1, 64, 64, 1)))
    if stats:     # non-trivial running statistics
        rs = np.random.RandomState(2)
        stats = jax.tree_util.tree_map(
            lambda a: (np.abs(a + 0.3 * rs.randn(*a.shape)) if a.min() > 0
                       else a + 0.3 * rs.randn(*a.shape)).astype(np.float32),
            stats)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    snap = os.path.join(str(tmp_path), "ACDC/zoo_1_labeledfinal", key)
    ckpt._save(ckpt._path(snap, 5), {"step": 5, "model":
                                     model_state_dict_from_flax(params,
                                                                stats)})
    test_2d.main(["--device", "cpu", "--root_path", acdc, "--exp",
                  "ACDC/zoo", "--labeled_num", "1", "--model", key,
                  "--snapshot_dir", str(tmp_path), "--input_size", "64",
                  "64", "--save_predictions", "1"])

    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    apply = jax.jit(lambda v, x: jm.apply(
        v, x, train=False, rngs={"dropout": jax.random.PRNGKey(0)})[0])
    logits_of = lambda x: apply(variables, x)

    from arco_torch.utils.volume_io import load_volume
    ds = JaxSliceDataset(acdc, split="val", list_name="test.list")
    pred_dir = os.path.join(str(tmp_path), "ACDC/zoo_1_labeledfinal",
                            f"{key}_predictions")
    for i, case in enumerate(ds.sample_list):
        image, label = ds.load(i)
        logits = np.concatenate([np.asarray(logits_of(
            jnp.asarray(image[j:j + 1, :, :, None]))) for j in
            range(image.shape[0])])
        top2 = np.sort(logits, axis=-1)[..., -2:]
        decided = top2[..., 1] - top2[..., 0] > 1e-4
        _, want = jax_test_volume(image, label,
                                  lambda x: jnp.argmax(logits_of(x), -1),
                                  4, (64, 64))
        name = next(f for f in os.listdir(pred_dir)
                    if f.startswith(f"{case}_pred."))
        got = load_volume(os.path.join(pred_dir, name))
        np.testing.assert_array_equal(got[decided], want[decided])


# ------------------------------------------------- the stage-2 step

def _stego_draws(rng, jmodel, variables, cfg):
    """test_torch_port_step's draws plus the encoder's dropout masks of the
    step's six forwards, along the JAX key chain (arco2d.py:249, :446)."""
    draws = _draws(rng, cfg, 2 * B)
    keys = jax.random.split(rng, 12)
    k_l, _, k_u, k_tps_fwd = jax.random.split(keys[9], 4)

    def masks(key, b):
        keeps = []
        with recording(keeps, []):
            jmodel.apply(variables, jnp.zeros((b, HW, HW, 1)), train=True,
                         rngs={"dropout": key}, mutable=["batch_stats"])
        return port_masks(keeps, False)

    draws["dropout"] = {name: masks(key, b) for name, key, b in (
        ("pseudo", keys[1], B), ("tl", keys[10], B), ("tu", keys[11], B),
        ("l", k_l, B), ("u", k_u, B), ("tps", k_tps_fwd, 2 * B))}
    return draws


@pytest.fixture(scope="module")
def stego_step():
    """One JAX step and one port step of unet_stego from the same state,
    batch and draws: (JAX state after, JAX metrics, port state, port
    metrics)."""
    jcfg = JaxArcoConfig(infonce_impl="pallas", pallas_tile=64, **CFG)
    jmodel = jax_net_factory("unet_stego", in_chns=1, class_num=NC)
    jmods = jax_arco2d.make_arco_modules(jmodel, HW, HW, batch_size=B)
    tx = jax_make_optimizer(0.01, 100)
    jstate = jax_arco2d.init_arco_state(jax.random.PRNGKey(0), jmods, jcfg,
                                        (B, HW, HW, 1), tx,
                                        pool_dtype=jnp.float32)
    start = _flax_state_numpy(jstate)
    draws = _stego_draws(jstate.rng, jmodel,
                         {"params": jstate.params["model"],
                          "batch_stats": jstate.batch_stats["model"]}, jcfg)
    grid = RandTPS(HW, HW, batch_size=2 * B).reset(draws["tps"]).numpy()
    jmods = jmods._replace(tps=_FixedGridTPS(jmods.tps, grid))
    image_l, label_l = _batch(0)
    image_u, _ = _batch(7)
    jstep = jax_arco2d.make_arco_step(jmods, jcfg, tx, num_classes=NC,
                                      max_iterations=100)
    jnew, jmetrics = jstep(jstate, {"image_l": jnp.asarray(image_l),
                                    "label_l": jnp.asarray(label_l),
                                    "image_u": jnp.asarray(image_u)})

    cfg = ArcoConfig(**CFG)
    mods = arco2d.make_arco_modules(UNetSTEGO(class_num=NC), HW, HW,
                                    batch_size=B)
    state = arco2d.init_arco_state(mods, cfg, (B, 1, HW, HW),
                                   OptimConfig(base_lr=0.01), device="cpu",
                                   compute_dtype=torch.float32,
                                   pool_dtype=torch.float32)
    load_flax_arco_state(state, start)
    step = arco2d.make_arco_step(mods, cfg, num_classes=NC,
                                 max_iterations=100,
                                 optim=OptimConfig(base_lr=0.01),
                                 device="cpu")
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    metrics = step(state, {"image_l": nchw(image_l),
                           "label_l": torch.from_numpy(label_l),
                           "image_u": nchw(image_u)}, draws)
    return (_flax_state_numpy(jnew),
            {k: np.asarray(v) for k, v in jmetrics.items()}, state, metrics)


# test_torch_port_step.py's tolerances: loss terms rtol 1e-4; weights,
# EMA copies, BatchNorm statistics, heads, bank and pool atol 1e-5 /
# rtol 1e-4; pointers and predicted labels exactly
@pytest.mark.parametrize("term", TERMS)
def test_stego_step_loss_terms(stego_step, term):
    _, jm, _, m = stego_step
    np.testing.assert_allclose(float(m[term]), float(jm[term]), **LOSS_TOL)


def test_stego_step_state(stego_step):
    ja, jm, state, m = stego_step
    np.testing.assert_array_equal(m["pred_l_label"].numpy(),
                                  jm["pred_l_label"])
    for module, params, stats in (
            (state.model, ja["params"]["model"], ja["batch_stats"]["model"]),
            (state.ema_model, ja["ema_params"]["model"],
             ja["ema_batch_stats"]["model"])):
        _assert_module(module, unet_stego_state_dict_from_flax(params,
                                                               stats),
                       **STATE_TOL)
    _assert_module(state.feature_extractor,
                   feature_extractor_state_dict_from_flax(
                       ja["params"]["feature_extractor"]), **STATE_TOL)
    _assert_module(state.q_representation, head_state_dict_from_flax(
        ja["params"]["q_representation"]), **STATE_TOL)
    np.testing.assert_array_equal(state.memobank.ptr.numpy(),
                                  ja["memobank"]["ptr"])
    np.testing.assert_allclose(state.memobank.data.numpy(),
                               ja["memobank"]["data"], **STATE_TOL)
    np.testing.assert_allclose(state.random_pool.numpy(), ja["random_pool"],
                               **STATE_TOL)
    assert state.step == ja["step"] == 1


# ------------------------------------------------------------- swin yaml

@pytest.fixture
def swin_recipe(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "MODEL:\n  SWIN:\n    EMBED_DIM: 48\n    DEPTHS: [2, 2, 2]\n"
        "    DECODER_DEPTHS: [2, 2, 1]\n    NUM_HEADS: [2, 4, 8]\n")
    (tmp_path / "mid.yaml").write_text(
        "BASE: ['base.yaml']\nDATA:\n  IMG_SIZE: 64\nMODEL:\n"
        "  DROP_PATH_RATE: 0.2\n  SWIN:\n    WINDOW_SIZE: 4\n")
    (tmp_path / "top.yaml").write_text(
        "BASE: ['mid.yaml']\nMODEL:\n  NUM_CLASSES: 4\n  SWIN:\n"
        "    APE: true\n")
    return str(tmp_path / "top.yaml"), ["MODEL.SWIN.QKV_BIAS", "false",
                                        "MODEL.DROP_RATE", "0.1"]


def test_swin_yaml_recipe_matches_jax(swin_recipe):
    path, opts = swin_recipe
    assert swin_config.load_swin_yaml(path, opts) == \
        jswin_config.load_swin_yaml(path, opts)
    kw = swin_config.swin_kwargs_from_yaml(path, opts, in_chns=1)
    assert kw == jswin_config.swin_kwargs_from_yaml(path, opts, in_chns=1)
    assert kw["embed_dim"] == 48 and kw["window_size"] == 4 \
        and kw["qkv_bias"] is False and kw["ape"] is True
    model = swin_config.build_swin_from_yaml(path, opts, in_chns=1)
    assert isinstance(model, SwinUnet)
    assert model.layers[0][0].attn.qkv.bias is None
    assert len(model.layers_up[-1]) == 1      # DECODER_DEPTHS[2]
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, 1, 64, 64))
    assert out[0].shape == (1, 4, 64, 64)
