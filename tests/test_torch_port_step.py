"""One stage-2 ARCO step of the PyTorch port against one JAX step.

Both start from the same state (the JAX state carried across by
arco_torch.compat.from_flax), take the same batch and the same random draws
(reproduced here with jax.random along the key chain of
arco_tpu/train/arco2d.py:446-447), and run in f32 with TF32 off. The JAX
step runs the Pallas InfoNCE kernel in interpret mode; the port runs the
plain versions of its kernels on the CPU. UNet dropout is 0 in both, and the
photometric/AdvMorph augmentations are off (not in the port's slice). The
confidence thresholds are lowered so that the randomly initialised teacher
clears them and the unsup term and the eqv mask are not trivially zero.

The JAX step is handed the TPS grid that the port computes from the same
draws. The grid comes from an ill-conditioned f32 solve, and JAX's in-jit
grid lies up to 1.4e-5 from a float64 solve (the port's 2.5e-6). The eqv
term's gradient is discontinuous in the grid: the max-pool argmax at the
edge of the zero-padded warp flips. So a grid that differs in its last bits
moves a few conv weights by up to 6e-5 after one step. The grid's own parity
is tested in test_torch_port_losses.py.

Tolerances: loss terms rtol 1e-4 (convolution and summation order differ
between XLA:CPU and PyTorch's CPU kernels); updated parameters, EMA copies,
BatchNorm statistics, bank rows and pool rows atol 1e-5 / rtol 1e-4 (one
SGD update at lr 0.01 of gradients that agree to ~1e-5 relative). Bank and
pool pointers, counts, the written bank slots and the predicted labels are
compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.models.unet2d import UNet as JaxUNet
from arco_tpu.train import arco2d as jax_arco2d
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.augment.tps import RandTPS
from arco_torch.compat.from_flax import (
    feature_extractor_state_dict_from_flax, load_flax_arco_state,
    head_state_dict_from_flax, unet_state_dict_from_flax)
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.models.unet2d import UNet
from arco_torch.train import arco2d

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

B, HW, NC = 2, 32, 4
CFG = dict(K=4, num_queries=16, num_negatives=8, memobank_size=128,
           memobank_size_bg=256, memobank_enqueue=32, topk=2,
           strong_threshold=0.3, weak_threshold=0.3,
           use_photometric=False, use_adv_morph=False)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _batch(seed):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, NC, size=(B, HW, HW)).astype(np.int32)
    image = label[..., None].astype(np.float32) / (NC - 1) \
        + 0.1 * rs.randn(B, HW, HW, 1).astype(np.float32)
    return image, label


def _flax_state_numpy(s):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"params": to_np(s.params), "batch_stats": to_np(s.batch_stats),
            "ema_params": to_np(s.ema_params),
            "ema_batch_stats": to_np(s.ema_batch_stats),
            "k_feature_params": to_np(s.k_feature_params),
            "memobank": {"data": np.asarray(s.memobank.data),
                         "ptr": np.asarray(s.memobank.ptr),
                         "count": np.asarray(s.memobank.count)},
            "random_pool": np.asarray(s.random_pool, np.float32),
            "random_pool_ptr": int(s.random_pool_ptr),
            "step": int(s.step)}


def _uniforms(key, n_classes, num):
    """The uniforms sampling.stratified_indices draws for each class key
    of compute_contra_memobank_loss (one split, then uniform)."""
    out = []
    for k in jax.random.split(key, n_classes):
        k_u, _ = jax.random.split(k)
        out.append(np.asarray(jax.random.uniform(k_u, (num,))))
    return torch.from_numpy(np.stack(out))


def _draws(rng, cfg, total_batch):
    """Reproduce the step's random draws from the JAX state's key."""
    keys = jax.random.split(rng, 12)
    k_mix, k_tps, k_contra = keys[2], keys[7], keys[8]

    boxes = []
    for key in jax.random.split(k_mix, B):
        k_w, k_x, k_y = jax.random.split(key, 3)
        rw = jax.random.randint(k_w, (), int(HW / 2.0) + 1, HW)
        rh = jnp.minimum(jnp.round(HW * HW / 2.0 / rw).astype(jnp.int32), HW)
        x0 = jax.random.randint(k_x, (), 0, jnp.maximum(HW - rw + 1, 1))
        y0 = jax.random.randint(k_y, (), 0, jnp.maximum(HW - rh + 1, 1))
        boxes.append([int(rw), int(x0), int(y0)])

    k_pert, k_aff, k_mir = jax.random.split(k_tps, 3)
    k_a, k_s, k_tx, k_ty = jax.random.split(k_aff, 4)
    u = lambda k, shape, lo, hi: torch.from_numpy(np.asarray(
        jax.random.uniform(k, shape, minval=lo, maxval=hi)))
    tps = {"pert": u(k_pert, (total_batch, 25, 2), -cfg.tps_sigma,
                     cfg.tps_sigma),
           "angle": u(k_a, (total_batch,), -60.0, 60.0),
           "scale": u(k_s, (total_batch,), 1.0 / 1.2, 1.0 / 0.8),
           "tx": u(k_tx, (total_batch,), -0.1, 0.1),
           "ty": u(k_ty, (total_batch,), -0.1, 0.1),
           "flip": torch.tensor(bool(jax.random.bernoulli(k_mir)))}

    k_anchor, k_neg, k_enq = jax.random.split(k_contra, 3)
    contra = {"enq": _uniforms(k_enq, NC, cfg.memobank_enqueue),
              "anchor": _uniforms(k_anchor, NC, cfg.num_queries),
              "neg": _uniforms(k_neg, NC,
                               cfg.num_queries * cfg.num_negatives)}
    return {"mix_boxes": torch.tensor(boxes), "tps": tps, "contra": contra}


class _FixedGridTPS:
    """The JAX RandTPS with its grid fixed to one the caller computed."""

    def __init__(self, inner, grid):
        self.inner, self.grid = inner, jnp.asarray(grid)

    def reset(self, rng):
        return self.grid

    def apply(self, *args, **kwargs):
        return self.inner.apply(*args, **kwargs)


def _assert_module(module, expected_sd, **tol):
    got = module.state_dict()
    for name, want in expected_sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   err_msg=name, **tol)


@pytest.fixture(scope="module")
def one_step_each():
    jcfg = JaxArcoConfig(infonce_impl="pallas", pallas_tile=64, **CFG)
    jmodel = JaxUNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5)
    jmods = jax_arco2d.make_arco_modules(jmodel, HW, HW, batch_size=B)
    tx = jax_make_optimizer(0.01, 100)
    jstate = jax_arco2d.init_arco_state(jax.random.PRNGKey(0), jmods, jcfg,
                                        (B, HW, HW, 1), tx,
                                        pool_dtype=jnp.float32)
    start = _flax_state_numpy(jstate)
    draws = _draws(jstate.rng, jcfg, 2 * B)
    grid = RandTPS(HW, HW, batch_size=2 * B).reset(draws["tps"]).numpy()
    jmods = jmods._replace(tps=_FixedGridTPS(jmods.tps, grid))

    image_l, label_l = _batch(0)
    image_u, _ = _batch(7)
    jstep = jax_arco2d.make_arco_step(jmods, jcfg, tx, num_classes=NC,
                                      max_iterations=100)
    jnew, jmetrics = jstep(jstate, {"image_l": jnp.asarray(image_l),
                                    "label_l": jnp.asarray(label_l),
                                    "image_u": jnp.asarray(image_u)})
    jax_after = _flax_state_numpy(jnew)
    jax_metrics = {k: np.asarray(v) for k, v in jmetrics.items()}

    cfg = ArcoConfig(**CFG)
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
    return jax_after, jax_metrics, state, metrics


TERMS = ["loss", "reco_loss", "loss_q", "unsup_loss", "loss_ce",
         "loss_dice", "loss_eqv"]


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms(one_step_each, term):
    _, jm, _, m = one_step_each
    np.testing.assert_allclose(float(m[term]), float(jm[term]), **LOSS_TOL)


def test_prediction_map(one_step_each):
    _, jm, _, m = one_step_each
    np.testing.assert_array_equal(m["pred_l_label"].numpy(),
                                  jm["pred_l_label"])


def test_student_params_and_bn_stats(one_step_each):
    ja, _, state, _ = one_step_each
    _assert_module(state.model, unet_state_dict_from_flax(
        ja["params"]["model"], ja["batch_stats"]["model"]), **STATE_TOL)


def test_teacher_ema_params_and_bn_stats(one_step_each):
    ja, _, state, _ = one_step_each
    _assert_module(state.ema_model, unet_state_dict_from_flax(
        ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]),
        **STATE_TOL)


def test_heads_and_feature_ema(one_step_each):
    ja, _, state, _ = one_step_each
    _assert_module(state.feature_extractor,
                   feature_extractor_state_dict_from_flax(
                       ja["params"]["feature_extractor"]), **STATE_TOL)
    _assert_module(state.q_representation,
                   head_state_dict_from_flax(
                       ja["params"]["q_representation"]), **STATE_TOL)
    _assert_module(state.k_feature_extractor,
                   feature_extractor_state_dict_from_flax(
                       ja["k_feature_params"]), **STATE_TOL)


def test_unsup_and_eqv_terms_are_live(one_step_each):
    _, jm, _, m = one_step_each
    assert float(jm["unsup_loss"]) > 0 and float(m["unsup_loss"]) > 0
    assert float(jm["loss_eqv"]) > 0 and float(jm["reco_loss"]) > 0


def test_memobank(one_step_each):
    ja, _, state, _ = one_step_each
    np.testing.assert_array_equal(state.memobank.ptr.numpy(),
                                  ja["memobank"]["ptr"])
    np.testing.assert_array_equal(state.memobank.count.numpy(),
                                  ja["memobank"]["count"])
    # the stratified enqueue wrote the same slots
    np.testing.assert_array_equal(
        (state.memobank.data != 0).any(-1).numpy(),
        (ja["memobank"]["data"] != 0).any(-1))
    np.testing.assert_allclose(state.memobank.data.numpy(),
                               ja["memobank"]["data"], **STATE_TOL)


def test_random_pool(one_step_each):
    ja, _, state, _ = one_step_each
    assert state.random_pool_ptr == ja["random_pool_ptr"] == B
    np.testing.assert_allclose(state.random_pool.numpy(), ja["random_pool"],
                               **STATE_TOL)
    assert state.step == ja["step"] == 1
