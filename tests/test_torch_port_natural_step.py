"""One natural-image ARCO step of the PyTorch port against one JAX step:
DeepLab-v2 at small depth (one block a layer) on 3-channel 65x65 images,
4 classes, bs 2+2, the four ResNet maps (256, 512, 1024, 2048) fused
fine -> coarse to a 256-channel 9x9 rep, BatchNorm scales and biases
frozen (train/freeze.py:apply_deeplab_bn_freeze, JAX's optax
multi_transform), photometric jitter/blur on RGB and AdvMorph on.

The set-up is test_torch_port_step_defaults.py's, at the natural shapes:
the port starts from the JAX state carried across by compat/from_flax.py,
takes the same batch and JAX's draws (the key chain of
arco_tpu/train/arco2d.py:446-447: cutmix boxes, the two photometric and the
two AdvMorph calls, TPS and the sampler uniforms), and runs in f32 with
TF32 off; the JAX step runs the Pallas InfoNCE kernel in interpret mode and
is handed the port's TPS and AdvMorph grids (their f32 rounding parity is
tested in test_torch_port_losses.py and test_torch_port_augment.py). The
labels resize to the 9x9 rep with the floor index rule at a ratio that is
no integer (65 -> 9), and some pixels are void (-1).

Tolerances (test_torch_port_step.py's): loss terms rtol 1e-4; parameters,
EMA copies, BatchNorm statistics, bank and pool rows atol 1e-5 / rtol
1e-4; pointers, counts, predicted labels and the frozen BatchNorm affine
parameters exactly. One exception: the student's updated weights are held
at atol 5e-5. The ReLUs right after train-mode BatchNorms of DeepLab's
small maps amplify f32 rounding in the gradients: in float64 the port's
gradients lie within 4e-7 of the largest from JAX's, while in float32 the
port's lie 2.2e-2 and JAX's 3.9e-2 of the largest from float64
(test_torch_port_natural.py, GRAD_F32_TOL). One SGD step at lr 0.01 moved
the student's first conv up to 1.71e-5 apart (2.56e-5 with the strong
augmentation off; scripts/torch_deeplab_rounding.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.models.deeplab import DeepLabV2 as JaxDeepLabV2
from arco_tpu.ops.interpolate import grid_sample_2d as jax_grid_sample_2d
from arco_tpu.train import arco2d as jax_arco2d
from arco_tpu.train.freeze import \
    apply_deeplab_bn_freeze as jax_apply_deeplab_bn_freeze
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.augment import morph
from arco_torch.augment.tps import RandTPS
from arco_torch.compat.from_flax import (
    deeplab_state_dict_from_flax, feature_extractor_state_dict_from_flax,
    head_state_dict_from_flax, load_flax_arco_state)
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.models.deeplab import DeepLabV2
from arco_torch.train import arco2d
from arco_torch.train.freeze import apply_deeplab_bn_freeze
from arco_torch.train.schedule import make_optimizer

from test_torch_port_augment import morph_draws, photometric_draws
from test_torch_port_step import (CFG, LOSS_TOL, STATE_TOL, TERMS,
                                  _assert_module, _flax_state_numpy,
                                  _FixedGridTPS, _uniforms)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

B, HW, NC = 2, 65, 4
LAYERS = (1, 1, 1, 1)
FEA, FUSED = (256, 512, 1024, 2048), 256
VEC = (HW // 8, HW // 8)
NATURAL = {**CFG, "use_photometric": True, "use_adv_morph": True}
STUDENT_TOL = dict(rtol=1e-4, atol=5e-5)


def natural_batch(seed, b=B, hw=HW, nc=NC):
    """Quadrant labels with a void band, RGB images that follow them."""
    rs = np.random.RandomState(seed)
    label = rs.randint(0, nc, size=(b, hw, hw)).astype(np.int32)
    label[:, :hw // 4, :hw // 2] = rs.randint(0, nc)
    label[:, -3:] = -1
    tint = np.array([0.2, 0.5, 0.8], np.float32)
    image = np.clip(label, 0, None)[..., None].astype(np.float32) \
        / (nc - 1) * tint + 0.1 * rs.randn(b, hw, hw, 3).astype(np.float32)
    return image, label


def natural_draws(rng, cfg, b=B, hw=HW, nc=NC):
    """Every draw of one step from the JAX state's key: cutmix boxes, TPS,
    the sampler uniforms, and the four strong-augmentation calls."""
    keys = jax.random.split(rng, 12)
    boxes = []
    for key in jax.random.split(keys[2], b):
        k_w, k_x, k_y = jax.random.split(key, 3)
        rw = jax.random.randint(k_w, (), int(hw / 2.0) + 1, hw)
        rh = jnp.minimum(jnp.round(hw * hw / 2.0 / rw).astype(jnp.int32), hw)
        x0 = jax.random.randint(k_x, (), 0, jnp.maximum(hw - rw + 1, 1))
        y0 = jax.random.randint(k_y, (), 0, jnp.maximum(hw - rh + 1, 1))
        boxes.append([int(rw), int(x0), int(y0)])
    total = 2 * b
    k_pert, k_aff, k_mir = jax.random.split(keys[7], 3)
    k_a, k_s, k_tx, k_ty = jax.random.split(k_aff, 4)
    u = lambda k, shape, lo, hi: torch.from_numpy(np.array(
        jax.random.uniform(k, shape, minval=lo, maxval=hi)))
    tps = {"pert": u(k_pert, (total, 25, 2), -cfg.tps_sigma, cfg.tps_sigma),
           "angle": u(k_a, (total,), -60.0, 60.0),
           "scale": u(k_s, (total,), 1.0 / 1.2, 1.0 / 0.8),
           "tx": u(k_tx, (total,), -0.1, 0.1),
           "ty": u(k_ty, (total,), -0.1, 0.1),
           "flip": torch.tensor(bool(jax.random.bernoulli(k_mir)))}
    k_anchor, k_neg, k_enq = jax.random.split(keys[8], 3)
    contra = {"enq": _uniforms(k_enq, nc, cfg.memobank_enqueue),
              "anchor": _uniforms(k_anchor, nc, cfg.num_queries),
              "neg": _uniforms(k_neg, nc,
                               cfg.num_queries * cfg.num_negatives)}
    vec = (hw // 8, hw // 8)
    return {"mix_boxes": torch.tensor(boxes), "tps": tps, "contra": contra,
            "photometric": {"cj1": photometric_draws(keys[3], b),
                            "cj2": photometric_draws(keys[4], b)},
            "morph": {"m1": morph_draws(keys[5], b, vec),
                      "m2": morph_draws(keys[6], b, vec)}}


def fixed_morph(draws, b=B, hw=HW):
    """adv_morph_batch for the JAX step: the port's grid for each of the
    two calls in turn, applied by the JAX warp and selection."""
    grids = []
    for name in ("m1", "m2"):
        m = morph.AdvMorph((b, 3, hw, hw), (hw // 8, hw // 8))
        grid = m.deformation_grid(m.init_params(draws[name]["velocity"]))
        grids.append((float(draws[name]["p"]), jnp.asarray(grid.numpy())))

    def adv_morph_batch(rng, images, p=0.5, epsilon=1.5, coarse_exp=True):
        u, grid = grids.pop(0)
        warped = jax_grid_sample_2d(images, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)
        return jnp.where(u > p, warped, images)
    return adv_morph_batch


def port_natural_state(cfg, model, start, b=B, hw=HW):
    """The port's state from the carried JAX state, BatchNorms frozen."""
    mods = arco2d.make_arco_modules(model, hw, hw, batch_size=b,
                                    feature_channels=FEA, fused_dim=FUSED)
    state = arco2d.init_arco_state(mods, cfg, (b, 3, hw, hw),
                                   OptimConfig(base_lr=0.01), device="cpu",
                                   compute_dtype=torch.float32,
                                   pool_dtype=torch.float32)
    load_flax_arco_state(state, start)
    state.optimizer = make_optimizer(
        apply_deeplab_bn_freeze(state.model)
        + list(state.feature_extractor.parameters())
        + list(state.q_representation.parameters()), 0.01)
    return mods, state


def run_one_step(natural=NATURAL):
    """One JAX step and one port step from the same state, batch and draws
    at the ArcoConfig fields ``natural``: (JAX's state after it, JAX's
    metrics, the port's state, its metrics, the draws, the port's frozen
    BatchNorm parameters before the step)."""
    jcfg = JaxArcoConfig(infonce_impl="pallas", pallas_tile=64, **natural)
    jmodel = JaxDeepLabV2(num_classes=NC, layers=LAYERS)
    jmods = jax_arco2d.make_arco_modules(jmodel, HW, HW, batch_size=B,
                                         feature_channels=FEA,
                                         fused_dim=FUSED)
    tx = jax_make_optimizer(0.01, 100)
    jstate = jax_arco2d.init_arco_state(jax.random.PRNGKey(0), jmods, jcfg,
                                        (B, HW, HW, 3), tx,
                                        pool_dtype=jnp.float32)
    tx = jax_apply_deeplab_bn_freeze(tx, jstate.params)
    jstate = jstate._replace(opt_state=tx.init(jstate.params))
    start = _flax_state_numpy(jstate)
    draws = natural_draws(jstate.rng, jcfg)
    grid = RandTPS(HW, HW, batch_size=2 * B).reset(draws["tps"]).numpy()
    jmods = jmods._replace(tps=_FixedGridTPS(jmods.tps, grid))

    image_l, label_l = natural_batch(0)
    image_u, _ = natural_batch(7)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_arco2d, "adv_morph_batch", fixed_morph(draws["morph"]))
    try:
        jstep = jax_arco2d.make_arco_step(jmods, jcfg, tx, num_classes=NC,
                                          max_iterations=100)
        jnew, jmetrics = jstep(jstate, {"image_l": jnp.asarray(image_l),
                                        "label_l": jnp.asarray(label_l),
                                        "image_u": jnp.asarray(image_u)})
        jax_after = _flax_state_numpy(jnew)
    finally:
        mp.undo()
    jax_metrics = {k: np.asarray(v) for k, v in jmetrics.items()}

    cfg = ArcoConfig(**natural)
    mods, state = port_natural_state(cfg, DeepLabV2(NC, LAYERS), start)
    frozen = {k: v.clone() for k, v in state.model.named_parameters()
              if not v.requires_grad}
    step = arco2d.make_arco_step(mods, cfg, num_classes=NC,
                                 max_iterations=100,
                                 optim=OptimConfig(base_lr=0.01),
                                 device="cpu")
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    metrics = step(state, {"image_l": nchw(image_l),
                           "label_l": torch.from_numpy(label_l),
                           "image_u": nchw(image_u)}, draws)
    return jax_after, jax_metrics, state, metrics, draws, frozen


@pytest.fixture(scope="module")
def one_step_each():
    return run_one_step()


def test_the_strong_augmentations_fired(one_step_each):
    draws = one_step_each[4]
    ph = draws["photometric"].values()
    assert any(bool((d["p_jitter"] > 0.5).any()) for d in ph)
    assert any(bool((d["p_blur"] > 0.5).any()) for d in ph)
    assert any(float(d["p"]) > 0.5 for d in draws["morph"].values())


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms(one_step_each, term):
    _, jm, _, m, _, _ = one_step_each
    np.testing.assert_allclose(float(m[term]), float(jm[term]), **LOSS_TOL)


def test_terms_are_live(one_step_each):
    _, jm, _, m, _, _ = one_step_each
    for term in ("reco_loss", "loss_q", "unsup_loss", "loss_eqv"):
        assert float(jm[term]) > 0 and float(m[term]) > 0, term


def test_prediction_map(one_step_each):
    _, jm, _, m, _, _ = one_step_each
    np.testing.assert_array_equal(m["pred_l_label"].numpy(),
                                  jm["pred_l_label"])


def test_student_params_and_bn_stats(one_step_each):
    ja, _, state, _, _, _ = one_step_each
    _assert_module(state.model, deeplab_state_dict_from_flax(
        ja["params"]["model"], ja["batch_stats"]["model"]), **STUDENT_TOL)


def test_batchnorm_affine_frozen(one_step_each):
    ja, _, state, _, _, frozen = one_step_each
    want = deeplab_state_dict_from_flax(ja["params"]["model"],
                                        ja["batch_stats"]["model"])
    params = dict(state.model.named_parameters())
    assert frozen and all(".bn" in k or "bn1" in k or "downsample.1" in k
                          for k in frozen)
    for name, before in frozen.items():
        assert torch.equal(params[name].detach(), before), name
        np.testing.assert_array_equal(before.numpy(), want[name].numpy())


def test_teacher_ema_params_and_bn_stats(one_step_each):
    ja, _, state, _, _, _ = one_step_each
    _assert_module(state.ema_model, deeplab_state_dict_from_flax(
        ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]),
        **STATE_TOL)


def test_heads_and_feature_ema(one_step_each):
    ja, _, state, _, _, _ = one_step_each
    _assert_module(state.feature_extractor,
                   feature_extractor_state_dict_from_flax(
                       ja["params"]["feature_extractor"]), **STATE_TOL)
    _assert_module(state.q_representation,
                   head_state_dict_from_flax(
                       ja["params"]["q_representation"]), **STATE_TOL)
    _assert_module(state.k_feature_extractor,
                   feature_extractor_state_dict_from_flax(
                       ja["k_feature_params"]), **STATE_TOL)


def test_memobank_and_pool(one_step_each):
    ja, _, state, _, _, _ = one_step_each
    np.testing.assert_array_equal(state.memobank.ptr.numpy(),
                                  ja["memobank"]["ptr"])
    np.testing.assert_array_equal(state.memobank.count.numpy(),
                                  ja["memobank"]["count"])
    np.testing.assert_allclose(state.memobank.data.numpy(),
                               ja["memobank"]["data"], **STATE_TOL)
    assert tuple(state.random_pool.shape) == (CFG["K"], 9, 9, FUSED)
    np.testing.assert_allclose(state.random_pool.numpy(), ja["random_pool"],
                               **STATE_TOL)
    assert state.random_pool_ptr == ja["random_pool_ptr"] == B
    assert state.step == ja["step"] == 1
