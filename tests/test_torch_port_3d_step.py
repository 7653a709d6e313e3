"""One stage-2 ARCO step of the PyTorch port's 3D path against one JAX step,
at default_3d_config's flags: V-Net (dropout on), 2 classes, fused dim 16,
the eqv term computed but left out of the loss, no photometric or AdvMorph
augmentation, a ``randn`` bank init row; K = 2 pool rows, Q = 16, N = 8,
128-row banks, 32x32x16 volumes, 2 labeled + 2 unlabeled.

The set-up is test_torch_port_step.py's: the JAX state carried across by
from_flax, the same batch, the JAX step's draws reproduced along its key
chain (arco_tpu/train/arco2d.py:446-447, :249), f32 with TF32 off, the
Pallas InfoNCE in interpret mode against the port's plain versions, the
port's TPS grid handed to the JAX step. Added here: the 3-D cutmix boxes
(rw, x0, y0, zl, z0) and the V-Net's two dropout masks of each of the six
forwards, read from JAX (test_torch_port_3d_models.jax_dropout_masks). The
no-eqv step of ``eqv_on_log_only`` is test_torch_port_3d_step_noeqv.py.

Tolerances: test_torch_port_step.py's (loss terms rtol 1e-4; updated
weights, EMA copies, BatchNorm statistics, bank and pool atol 1e-5 / rtol
1e-4; pointers exactly), but for three quantities that the entropy split
makes discontinuous. The train-mode V-Net's outputs carry ~1e-4 of f32
rounding (test_torch_port_3d_models.py), which moves the student's voxel
entropies by up to 1e-5; at random init they crowd the split's percentile
thresholds, so a few voxels change sides (2 of 32768 between the port's
f32 and float64 steps), and the stratified anchor draw then picks other
voxels. JAX's reco_loss lies 2e-6 from the port's float64 step and 1.4e-3
from its f32 step. So reco_loss is held to rtol 5e-3, the student's
weights, which take k1 times its gradient, to atol 5e-5 (2.3e-5 measured,
in block_one's conv), and at most 0.1% of the predicted labels may differ
(voxels whose two logits nearly tie; 1 of 32768 measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.models.factory import net_factory_3d as jax_net_factory_3d
from arco_tpu.train import arco2d as jax_arco2d
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.augment.tps import RandTPS
from arco_torch.compat.from_flax import (
    feature_extractor_state_dict_from_flax, head_state_dict_from_flax,
    load_flax_arco_state, vnet_state_dict_from_flax)
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.models import net_factory_3d
from arco_torch.train import arco2d

from test_torch_port_3d_models import (S, cutout_boxes_3d,
                                       jax_dropout_masks, ncdhw)
from test_torch_port_step import (LOSS_TOL, STATE_TOL, TERMS,
                                  _assert_module, _flax_state_numpy,
                                  _FixedGridTPS, _uniforms)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

B, NC = 2, 2
FEA, FUSED = (128, 64, 32, 16, 16), 16
CFG3D = dict(K=2, num_queries=16, num_negatives=8, memobank_size=128,
             memobank_size_bg=128, memobank_enqueue=32, topk=2,
             strong_threshold=0.55, weak_threshold=0.55,
             use_eqv_loss=False, compute_eqv=True, use_photometric=False,
             use_adv_morph=False, memobank_init="randn")


def batch3d(seed):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, NC, size=(B,) + S).astype(np.int32)
    image = label[..., None].astype(np.float32) \
        + 0.2 * rs.randn(B, *S, 1).astype(np.float32)
    return image, label


def draws_3d(rng, jmodel, variables, tps_sigma):
    """The step's draws along the JAX key chain: cutmix boxes, TPS, sampler
    uniforms, and the dropout masks of the six forwards (teacher: pseudo,
    tl, tu; student: l, u, tps)."""
    keys = jax.random.split(rng, 12)
    k_mix, k_tps, k_contra, k_loss = keys[2], keys[7], keys[8], keys[9]
    k_l, _, k_u, k_tps_fwd = jax.random.split(k_loss, 4)
    k_pert, k_aff, k_mir = jax.random.split(k_tps, 3)
    k_a, k_s, k_tx, k_ty = jax.random.split(k_aff, 4)
    u = lambda k, shape, lo, hi: torch.from_numpy(np.array(
        jax.random.uniform(k, shape, minval=lo, maxval=hi)))
    t = 2 * B
    tps = {"pert": u(k_pert, (t, 25, 2), -tps_sigma, tps_sigma),
           "angle": u(k_a, (t,), -60.0, 60.0),
           "scale": u(k_s, (t,), 1.0 / 1.2, 1.0 / 0.8),
           "tx": u(k_tx, (t,), -0.1, 0.1),
           "ty": u(k_ty, (t,), -0.1, 0.1),
           "flip": torch.tensor(bool(jax.random.bernoulli(k_mir)))}
    k_anchor, k_neg, k_enq = jax.random.split(k_contra, 3)
    q, n = CFG3D["num_queries"], CFG3D["num_negatives"]
    contra = {"enq": _uniforms(k_enq, NC, CFG3D["memobank_enqueue"]),
              "anchor": _uniforms(k_anchor, NC, q),
              "neg": _uniforms(k_neg, NC, q * n)}
    # the TPS forward takes the labeled and unlabeled images together
    dropout = {name: jax_dropout_masks(jmodel, variables,
                                       (b,) + S + (1,), key)
               for name, key, b in (("pseudo", keys[1], B),
                                    ("tl", keys[10], B), ("tu", keys[11], B),
                                    ("l", k_l, B), ("u", k_u, B),
                                    ("tps", k_tps_fwd, 2 * B))}
    return {"mix_boxes": cutout_boxes_3d(k_mix, B, S), "tps": tps,
            "contra": contra, "dropout": dropout}


def step_pair(compute_eqv: bool):
    """One JAX step and one port step from the same state, batch and draws:
    (JAX state after, JAX metrics, port state, port metrics)."""
    flags = {**CFG3D, "compute_eqv": compute_eqv}
    jcfg = JaxArcoConfig(infonce_impl="pallas", pallas_tile=64, **flags)
    jmodel = jax_net_factory_3d("vnet", in_chns=1, class_num=NC)
    jmods = jax_arco2d.make_arco_modules(jmodel, S[1], S[0], batch_size=B,
                                         feature_channels=FEA,
                                         fused_dim=FUSED)
    tx = jax_make_optimizer(0.01, 100)
    jstate = jax_arco2d.init_arco_state(jax.random.PRNGKey(0), jmods, jcfg,
                                        (B,) + S + (1,), tx,
                                        pool_dtype=jnp.float32)
    start = _flax_state_numpy(jstate)
    draws = draws_3d(jstate.rng, jmodel,
                     {"params": jstate.params["model"],
                      "batch_stats": jstate.batch_stats["model"]},
                     jcfg.tps_sigma)
    grid = RandTPS(S[1], S[0], batch_size=2 * B).reset(draws["tps"]).numpy()
    jmods = jmods._replace(tps=_FixedGridTPS(jmods.tps, grid))

    image_l, label_l = batch3d(0)
    image_u, _ = batch3d(7)
    jstep = jax_arco2d.make_arco_step(jmods, jcfg, tx, num_classes=NC,
                                      max_iterations=100)
    jnew, jmetrics = jstep(jstate, {"image_l": jnp.asarray(image_l),
                                    "label_l": jnp.asarray(label_l),
                                    "image_u": jnp.asarray(image_u)})
    jax_after = _flax_state_numpy(jnew)
    jax_metrics = {k: np.asarray(v) for k, v in jmetrics.items()}

    cfg = ArcoConfig(**flags)
    mods = arco2d.make_arco_modules(
        net_factory_3d("vnet", in_chns=1, class_num=NC), S[1], S[0],
        batch_size=B, feature_channels=FEA, fused_dim=FUSED)
    state = arco2d.init_arco_state(mods, cfg, (B, 1) + S,
                                   OptimConfig(base_lr=0.01), device="cpu",
                                   compute_dtype=torch.float32,
                                   pool_dtype=torch.float32)
    load_flax_arco_state(state, start)
    step = arco2d.make_arco_step(mods, cfg, num_classes=NC,
                                 max_iterations=100,
                                 optim=OptimConfig(base_lr=0.01),
                                 device="cpu")
    metrics = step(state, {"image_l": ncdhw(image_l),
                           "label_l": torch.from_numpy(label_l),
                           "image_u": ncdhw(image_u)}, draws)
    return jax_after, jax_metrics, state, metrics


@pytest.fixture(scope="module")
def one_step_each():
    return step_pair(compute_eqv=True)


RECO_TOL = dict(rtol=5e-3, atol=1e-6)
STUDENT_TOL = dict(rtol=1e-4, atol=5e-5)


def check_loss_term(pair, term):
    _, jm, _, m = pair
    np.testing.assert_allclose(float(m[term]), float(jm[term]),
                               **(RECO_TOL if term == "reco_loss"
                                  else LOSS_TOL))


def check_state(pair):
    """Student and teacher V-Nets with their BatchNorm statistics, the
    heads and the teacher feature extractor, the bank, pool and pointers,
    and the predicted labels."""
    ja, jm, state, m = pair
    want = vnet_state_dict_from_flax(ja["params"]["model"],
                                     ja["batch_stats"]["model"])
    _assert_module(state.model, {k: v for k, v in want.items()
                                 if "running" in k}, **STATE_TOL)
    _assert_module(state.model, {k: v for k, v in want.items()
                                 if "running" not in k}, **STUDENT_TOL)
    _assert_module(state.ema_model, vnet_state_dict_from_flax(
        ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]),
        **STATE_TOL)
    _assert_module(state.feature_extractor,
                   feature_extractor_state_dict_from_flax(
                       ja["params"]["feature_extractor"]), **STATE_TOL)
    _assert_module(state.q_representation, head_state_dict_from_flax(
        ja["params"]["q_representation"]), **STATE_TOL)
    _assert_module(state.k_feature_extractor,
                   feature_extractor_state_dict_from_flax(
                       ja["k_feature_params"]), **STATE_TOL)
    np.testing.assert_array_equal(state.memobank.ptr.numpy(),
                                  ja["memobank"]["ptr"])
    np.testing.assert_array_equal(state.memobank.count.numpy(),
                                  ja["memobank"]["count"])
    np.testing.assert_allclose(state.memobank.data.numpy(),
                               ja["memobank"]["data"], **STATE_TOL)
    np.testing.assert_allclose(state.random_pool.numpy(), ja["random_pool"],
                               **STATE_TOL)
    assert state.random_pool_ptr == ja["random_pool_ptr"] == B % CFG3D["K"]
    assert state.step == ja["step"] == 1
    assert (m["pred_l_label"].numpy() != jm["pred_l_label"]).mean() <= 1e-3


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms(one_step_each, term):
    check_loss_term(one_step_each, term)


def test_state_after_the_step(one_step_each):
    check_state(one_step_each)


def test_eqv_is_computed_but_out_of_the_loss(one_step_each):
    _, jm, _, m = one_step_each
    assert float(m["loss_eqv"]) > 0 and float(m["reco_loss"]) > 0
    assert float(m["unsup_loss"]) > 0
    rest = sum(float(m[k]) for k in ("loss_ce", "loss_dice", "unsup_loss",
                                     "loss_q")) + 0.01 * float(m["reco_loss"])
    np.testing.assert_allclose(float(m["loss"]), rest, rtol=1e-5)


def test_default_3d_config_flags():
    """The port's CLI defaults are the JAX CLI's."""
    from arco_tpu.cli.train_arco_3d import default_3d_config as jax_default
    from arco_torch.cli.train_arco_3d import default_3d_config
    got, want = default_3d_config(), jax_default()
    for part in ("data", "optim", "arco"):
        for f in dataclasses.fields(getattr(want, part)):
            assert getattr(getattr(got, part), f.name) == getattr(
                getattr(want, part), f.name), f"{part}.{f.name}"
    assert got.model == want.model == "vnet"
