"""One stage-2 ARCO step of the PyTorch port against one JAX step at the
ArcoConfig defaults of the strong augmentation: photometric jitter/blur and
AdvMorph on.

The set-up is test_torch_port_step.py's (same state, batch, tolerances and
JAX key chain, f32, dropout 0, the port's TPS grid handed to the JAX step),
with the four strong-augmentation draws added: batch_photometric from
keys[3] and keys[4], adv_morph_batch from keys[5] and keys[6]
(arco_tpu/train/arco2d.py:446-447, :479-487). The draws are checked to fire
AdvMorph and at least one jitter and one blur.

The JAX step is also handed the port's AdvMorph grids, computed from the
same draws: scaling and squaring leaves the two grids up to ~5e-5 apart
(test_torch_port_augment.py), and at 32x32 that moves a warped pixel by
~1e-3 of a pixel, which the max-pool argmax of the five forwards can turn
into weight changes above the 1e-5 state tolerance. The grids' own parity is
tested in test_torch_port_augment.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.models.unet2d import UNet as JaxUNet
from arco_tpu.ops.interpolate import grid_sample_2d as jax_grid_sample_2d
from arco_tpu.train import arco2d as jax_arco2d
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.augment import morph
from arco_torch.augment.tps import RandTPS
from arco_torch.compat.from_flax import (
    feature_extractor_state_dict_from_flax, load_flax_arco_state,
    head_state_dict_from_flax, unet_state_dict_from_flax)
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.models.unet2d import UNet
from arco_torch.train import arco2d

from test_torch_port_augment import morph_draws, photometric_draws
from test_torch_port_step import (B, CFG, HW, LOSS_TOL, NC, STATE_TOL, TERMS,
                                  _assert_module, _batch, _draws,
                                  _flax_state_numpy, _FixedGridTPS)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

DEFAULTS = {**CFG, "use_photometric": True, "use_adv_morph": True}
VEC = (HW // 8, HW // 8)


def _strong_draws(rng):
    keys = jax.random.split(rng, 12)
    return {"photometric": {"cj1": photometric_draws(keys[3], B),
                            "cj2": photometric_draws(keys[4], B)},
            "morph": {"m1": morph_draws(keys[5], B, VEC),
                      "m2": morph_draws(keys[6], B, VEC)}}


def _fixed_morph(draws):
    """adv_morph_batch for the JAX step: the port's grid for each of the
    two calls in turn, applied by the JAX warp and selection."""
    grids = []
    for name in ("m1", "m2"):
        m = morph.AdvMorph((B, 1, HW, HW), VEC)
        grid = m.deformation_grid(m.init_params(draws[name]["velocity"]))
        grids.append((float(draws[name]["p"]), jnp.asarray(grid.numpy())))

    def adv_morph_batch(rng, images, p=0.5, epsilon=1.5, coarse_exp=True):
        u, grid = grids.pop(0)
        warped = jax_grid_sample_2d(images, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)
        return jnp.where(u > p, warped, images)
    return adv_morph_batch


@pytest.fixture(scope="module")
def one_step_each():
    jcfg = JaxArcoConfig(infonce_impl="pallas", pallas_tile=64, **DEFAULTS)
    jmodel = JaxUNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5)
    jmods = jax_arco2d.make_arco_modules(jmodel, HW, HW, batch_size=B)
    tx = jax_make_optimizer(0.01, 100)
    jstate = jax_arco2d.init_arco_state(jax.random.PRNGKey(0), jmods, jcfg,
                                        (B, HW, HW, 1), tx,
                                        pool_dtype=jnp.float32)
    start = _flax_state_numpy(jstate)
    draws = {**_draws(jstate.rng, jcfg, 2 * B), **_strong_draws(jstate.rng)}
    grid = RandTPS(HW, HW, batch_size=2 * B).reset(draws["tps"]).numpy()
    jmods = jmods._replace(tps=_FixedGridTPS(jmods.tps, grid))

    image_l, label_l = _batch(0)
    image_u, _ = _batch(7)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_arco2d, "adv_morph_batch", _fixed_morph(draws["morph"]))
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

    cfg = ArcoConfig(**DEFAULTS)
    model = UNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5)
    mods = arco2d.make_arco_modules(model, HW, HW, batch_size=B)
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
    return jax_after, jax_metrics, state, metrics, draws


def test_the_strong_augmentations_fired(one_step_each):
    draws = one_step_each[-1]
    ph = draws["photometric"].values()
    assert any(bool((d["p_jitter"] > 0.5).any()) for d in ph)
    assert any(bool((d["p_blur"] > 0.5).any()) for d in ph)
    assert any(float(d["p"]) > 0.5 for d in draws["morph"].values())


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms(one_step_each, term):
    _, jm, _, m, _ = one_step_each
    np.testing.assert_allclose(float(m[term]), float(jm[term]), **LOSS_TOL)


def test_prediction_map(one_step_each):
    _, jm, _, m, _ = one_step_each
    np.testing.assert_array_equal(m["pred_l_label"].numpy(),
                                  jm["pred_l_label"])


def test_student_params_and_bn_stats(one_step_each):
    ja, _, state, _, _ = one_step_each
    _assert_module(state.model, unet_state_dict_from_flax(
        ja["params"]["model"], ja["batch_stats"]["model"]), **STATE_TOL)


def test_teacher_ema_params_and_bn_stats(one_step_each):
    ja, _, state, _, _ = one_step_each
    _assert_module(state.ema_model, unet_state_dict_from_flax(
        ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]),
        **STATE_TOL)


def test_heads_and_feature_ema(one_step_each):
    ja, _, state, _, _ = one_step_each
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
    ja, _, state, _, _ = one_step_each
    np.testing.assert_array_equal(state.memobank.ptr.numpy(),
                                  ja["memobank"]["ptr"])
    np.testing.assert_array_equal(state.memobank.count.numpy(),
                                  ja["memobank"]["count"])
    np.testing.assert_allclose(state.memobank.data.numpy(),
                               ja["memobank"]["data"], **STATE_TOL)
    np.testing.assert_allclose(state.random_pool.numpy(), ja["random_pool"],
                               **STATE_TOL)
    assert state.step == ja["step"] == 1
