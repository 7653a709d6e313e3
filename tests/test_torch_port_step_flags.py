"""One stage-2 2D step of the PyTorch port against one JAX step with the
three trajectory-parity flags on together: ``dead_forward`` (the
reference's extra student forward on the labeled batch, which only moves
the BatchNorm statistics), ``quantize_augs`` (augmented images and
confidences floor-quantized to 1/255) and ``fast_percentile`` (the
histogram percentile of the entropy split), against
arco_tpu/train/arco2d.py:259-266, :490-501 and :312.

The set-up, draws and tolerances are test_torch_port_step.py's (f32,
dropout 0, strong augmentation off, the port's TPS grid handed to JAX).
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
from arco_torch.compat.from_flax import (load_flax_arco_state,
                                         unet_state_dict_from_flax)
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.models.unet2d import UNet
from arco_torch.train import arco2d

from test_torch_port_step import (B, CFG, HW, LOSS_TOL, NC, STATE_TOL, TERMS,
                                  _assert_module, _batch, _draws,
                                  _flax_state_numpy, _FixedGridTPS)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

FLAGS = {**CFG, "dead_forward": True, "quantize_augs": True,
         "fast_percentile": True}


@pytest.fixture(scope="module")
def one_step_each():
    jcfg = JaxArcoConfig(infonce_impl="pallas", pallas_tile=64, **FLAGS)
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

    cfg = ArcoConfig(**FLAGS)
    mods = arco2d.make_arco_modules(
        UNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5), HW, HW,
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
    return jax_after, jax_metrics, state, metrics


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms(one_step_each, term):
    _, jm, _, m = one_step_each
    np.testing.assert_allclose(float(m[term]), float(jm[term]), **LOSS_TOL)


def test_student_and_teacher_with_the_dead_forwards_statistics(
        one_step_each):
    """The student's BatchNorm statistics took three forwards (labeled,
    dead, unlabeled) before the TPS one, in both."""
    ja, _, state, m = one_step_each
    _assert_module(state.model, unet_state_dict_from_flax(
        ja["params"]["model"], ja["batch_stats"]["model"]), **STATE_TOL)
    _assert_module(state.ema_model, unet_state_dict_from_flax(
        ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]),
        **STATE_TOL)
    np.testing.assert_allclose(state.memobank.data.numpy(),
                               ja["memobank"]["data"], **STATE_TOL)
    np.testing.assert_array_equal(state.memobank.ptr.numpy(),
                                  ja["memobank"]["ptr"])
    np.testing.assert_allclose(state.random_pool.numpy(), ja["random_pool"],
                               **STATE_TOL)
