"""The small 2D modules of the port against the JAX package, the
distribution of its samplers, and the stage-2 step's ``remat`` option.

- ``utils/ramps.py`` against arco_tpu's, rtol 1e-6 (f32 on both sides);
  ``data/transforms2d.py`` and ``data/cache.py`` exactly (the same numpy
  and scipy code from the same RandomState).
- The port's 'smc' and 'asmc' samplers, drawn from a torch.Generator,
  against uniform draws, on the pattern of test_sampler_distribution.py:
  support, mean and decile coverage, and the variance reduction of the
  stratified estimators. Thresholds are those of that file.
- ``remat=True`` against ``remat=False``: one port step at the
  ArcoConfig defaults (strong augmentation on, U-Net dropout on, drawn from
  the state's generator) leaves the student, the teacher, their BatchNorm
  running statistics and ``num_batches_tracked``, the heads and the
  generator bit for bit equal (CPU, one thread). And one port step with
  ``remat=True`` against one JAX step with ``remat=True``, in the set-up
  and at the tolerances of test_torch_port_step.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.data import cache as jcache
from arco_tpu.data import datasets as jdatasets
from arco_tpu.data import transforms2d as jtransforms2d
from arco_tpu.models.unet2d import UNet as JaxUNet
from arco_tpu.train import arco2d as jax_arco2d
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer
from arco_tpu.utils import ramps as jramps

from arco_torch.augment.tps import RandTPS
from arco_torch.compat.from_flax import (load_flax_arco_state,
                                         unet_state_dict_from_flax)
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.data import cache, datasets, transforms2d
from arco_torch.data.synthetic import make_acdc_like
from arco_torch.models import net_factory
from arco_torch.models.unet2d import UNet
from arco_torch.ops import sampling
from arco_torch.train import arco2d
from arco_torch.utils import ramps

from test_torch_port_step import (B, CFG, HW, LOSS_TOL, NC, STATE_TOL, TERMS,
                                  _assert_module, _batch, _draws,
                                  _flax_state_numpy, _FixedGridTPS)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ ramps

RAMPS = [("sigmoid_rampup", (40.0,)), ("linear_rampup", (40.0,)),
         ("cosine_rampdown", (40.0,)), ("exp_rampup", (40.0,)),
         ("cosine_temperature", (40.0,)),
         ("cosine_temperature", (40.0, 0.2, 0.7))]


@pytest.mark.parametrize("name,args", RAMPS)
def test_ramps_match_jax(name, args):
    currents = np.array([0.0, 3.0, 17.5, 40.0, 55.0], np.float32)
    for cur in list(currents) + [currents]:
        want = np.asarray(getattr(jramps, name)(jnp.asarray(cur), *args))
        got = getattr(ramps, name)(torch.as_tensor(cur), *args)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # a Python number works too
    np.testing.assert_allclose(float(getattr(ramps, name)(17.5, *args)),
                               float(getattr(jramps, name)(17.5, *args)),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["sigmoid_rampup", "linear_rampup",
                                  "exp_rampup"])
def test_zero_length_ramps_are_one(name):
    assert getattr(ramps, name)(5.0, 0) == getattr(jramps, name)(5.0, 0) \
        == 1.0


# ------------------------------------------------------------- transforms

def _transform_cases():
    img = np.random.RandomState(0).rand(30, 26).astype(np.float32)
    lab = (img * 3).astype(np.int32)
    return [
        ("center_crop", lambda m, rs: m.center_crop(img, lab, (20, 20))),
        ("center_crop_pads", lambda m, rs: m.center_crop(img, lab,
                                                         (32, 40))),
        ("random_crop", lambda m, rs: m.random_crop(rs, img, lab, (16, 12))),
        ("random_noise", lambda m, rs: m.random_noise(rs, img, p=1.0)),
        ("random_color_jitter",
         lambda m, rs: m.random_color_jitter(rs, img, p=1.0)),
        ("brightness_transform",
         lambda m, rs: m.brightness_transform(rs, img)),
        ("create_onehot_label",
         lambda m, rs: m.create_onehot_label(lab, 3)),
        ("resize", lambda m, rs: m.resize(img, lab, (16, 16))),
        ("custom_multi_cropping",
         lambda m, rs: m.custom_multi_cropping(
             rs, img, lab, size_large=(12, 12), size_small=(6, 6))),
    ]


def _flatten(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flatten(o)]
    return [np.asarray(out)]


@pytest.mark.parametrize("case", _transform_cases(), ids=lambda c: c[0])
def test_transforms2d_match_jax(case):
    _, fn = case
    want = _flatten(fn(jtransforms2d, np.random.RandomState(4)))
    got = _flatten(fn(transforms2d, np.random.RandomState(4)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ cache

@pytest.fixture(scope="module")
def acdc(tmp_path_factory):
    base = tmp_path_factory.mktemp("leftovers")
    return make_acdc_like(str(base / "ACDC"), n_train=6, n_val=1,
                          size=(24, 20), num_classes=3), base


def test_cache_matches_jax(acdc):
    root, base = acdc
    ds = datasets.SliceDataset(root, "train", output_size=(16, 16))
    jds = jdatasets.SliceDataset(root, "train", output_size=(16, 16))
    got = cache.CachedSliceDataset(ds, str(base / "port"), size=(24, 20))
    want = jcache.CachedSliceDataset(jds, str(base / "jax"), size=(24, 20))
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(got.cache.images, want.cache.images)
    np.testing.assert_array_equal(got.cache.labels, want.cache.labels)
    rs_g, rs_w = np.random.RandomState(2), np.random.RandomState(2)
    for i in range(len(got)):
        g, w = got.get(i, rs_g), want.get(i, rs_w)
        for k in ("image", "label", "idx"):
            np.testing.assert_array_equal(g[k], w[k])
    # a second build reuses the pack
    again = cache.build_cache(ds, str(base / "port"))
    np.testing.assert_array_equal(again.images, got.cache.images)
    # a ragged set without a size is not packed
    assert cache.build_cache(_Ragged(), str(base / "ragged")) is None


class _Ragged:
    def __len__(self):
        return 2

    def load(self, idx):
        n = 4 + idx
        return np.zeros((n, n), np.float32), np.zeros((n, n), np.int16)


# --------------------------------------------------------------- samplers

HIGH, SHAPE = 5000, 256


def _draws_of(func, n_draws, high, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return np.concatenate([
        sampling.draw_indices(high, shape, func=func, generator=gen).numpy()
        for _ in range(n_draws)])


@pytest.mark.parametrize("func", ["smc", "asmc", "uniform"])
def test_sampler_support_mean_and_coverage(func):
    draws = _draws_of(func, 30, HIGH, SHAPE, 0)
    assert draws.min() >= 0 and draws.max() < HIGH
    np.testing.assert_allclose(draws.mean(), (HIGH - 1) / 2, rtol=0.05)
    hist, _ = np.histogram(draws, bins=10, range=(0, HIGH))
    assert hist.min() > 0.6 * len(draws) / 10


def _estimator_variance(values, func, shape, n=60):
    gen = torch.Generator().manual_seed(1)
    means = [values[sampling.draw_indices(len(values), shape, func=func,
                                          generator=gen).numpy()].mean()
             for _ in range(n)]
    return np.var(means), np.mean(means)


def test_stratified_reduces_variance_vs_uniform():
    high, shape = 4096, 64
    values = np.sin(np.linspace(0, 12, high)) + np.linspace(0, 1, high)
    v_smc, m_smc = _estimator_variance(values, "smc", shape)
    v_asmc, m_asmc = _estimator_variance(values, "asmc", shape)
    v_unif, _ = _estimator_variance(values, "uniform", shape)
    assert abs(m_smc - values.mean()) < 0.05
    assert abs(m_asmc - values.mean()) < 0.05
    assert v_smc < v_unif and v_asmc < v_unif


def test_antithetic_variance_on_a_monotone_integrand():
    high, shape = 4096, 64
    values = np.linspace(0, 1, high) ** 3
    v_smc, _ = _estimator_variance(values, "smc", shape)
    v_asmc, _ = _estimator_variance(values, "asmc", shape)
    assert v_asmc <= v_smc * 1.1


# ------------------------------------------------------------------ remat

SMALL = dict(K=2, num_queries=16, num_negatives=8, memobank_size=64,
             memobank_size_bg=64, memobank_enqueue=16, topk=2,
             strong_threshold=0.3, weak_threshold=0.3)


def _remat_run(remat):
    cfg = ArcoConfig(remat=remat, **SMALL)
    torch.manual_seed(0)
    mods = arco2d.make_arco_modules(net_factory("unet", class_num=4), 32, 32,
                                    batch_size=2)
    state = arco2d.init_arco_state(mods, cfg, (2, 1, 32, 32), seed=3,
                                   device="cpu", compute_dtype=torch.float32)
    step = arco2d.make_arco_step(mods, cfg, num_classes=4,
                                 max_iterations=100, device="cpu")
    rs = np.random.RandomState(0)
    label = rs.randint(0, 4, (2, 32, 32)).astype(np.int32)
    batch = {"image_l": torch.from_numpy(
        label[:, None].astype(np.float32) / 3
        + 0.1 * rs.randn(2, 1, 32, 32).astype(np.float32)),
        "label_l": torch.from_numpy(label),
        "image_u": torch.from_numpy(rs.rand(2, 1, 32, 32)
                                    .astype(np.float32))}
    return state, step(state, batch)


def test_remat_step_is_bit_identical():
    (a, ma), (b, mb) = _remat_run(False), _remat_run(True)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for name in ("model", "ema_model", "feature_extractor",
                 "k_feature_extractor", "q_representation"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.memobank.data, b.memobank.data)
    assert torch.equal(a.random_pool, b.random_pool)
    # the BatchNorm layers update their statistics again after the step
    assert all(m.update_stats for m in b.model.modules()
               if hasattr(m, "update_stats"))


@pytest.fixture(scope="module")
def remat_step_each():
    """One remat step of JAX and of the port from the same state (the
    set-up of test_torch_port_step.py with ``remat=True``)."""
    jcfg = JaxArcoConfig(infonce_impl="pallas", pallas_tile=64, remat=True,
                         **CFG)
    jmods = jax_arco2d.make_arco_modules(
        JaxUNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5), HW, HW,
        batch_size=B)
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

    cfg = dataclasses.replace(ArcoConfig(**CFG), remat=True)
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
    return jax_after, {k: np.asarray(v) for k, v in jmetrics.items()}, \
        state, metrics


@pytest.mark.parametrize("term", TERMS)
def test_remat_step_matches_jax_remat_loss_terms(remat_step_each, term):
    _, jm, _, m = remat_step_each
    np.testing.assert_allclose(float(m[term]), float(jm[term]), **LOSS_TOL)


def test_remat_step_matches_jax_remat_state(remat_step_each):
    ja, _, state, _ = remat_step_each
    _assert_module(state.model, unet_state_dict_from_flax(
        ja["params"]["model"], ja["batch_stats"]["model"]), **STATE_TOL)
    _assert_module(state.ema_model, unet_state_dict_from_flax(
        ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]),
        **STATE_TOL)
