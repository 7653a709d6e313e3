"""The strong augmentations of the PyTorch port against the JAX package: the
gaussian blurs, the photometric jitter/blur and AdvMorph (CPU, float32).

Inputs come from numpy seeds; the random draws are the JAX functions' own,
reproduced along their key chains (arco_tpu/augment/photometric.py:74-81,
:31, :63; arco_tpu/augment/morph.py:190-195) and fed to the port.
Tolerances: the blurs atol 1e-6 (the same f32 products summed in another
order); photometric atol 1e-5. AdvMorph grids atol 1e-4: scaling and
squaring composes the field with itself 8 times, and each composition
doubles the rounding error that the f32 coordinates (ulp 1.2e-7 near 1)
carry, so 2^8 x 1.2e-7 = 3e-5 per side. Against a float64 run of the same
algorithm the JAX grid lies up to 5.7e-5 off at 256x256 and the port's
3.2e-5. Warped images are smooth here (|dI/dx| < 1.2 per unit of
the normalized grid), so they are held at atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.augment import morph as jmorph
from arco_tpu.augment import photometric as jphoto
from arco_tpu.ops import gaussian as jgauss

from arco_torch.augment import morph, photometric
from arco_torch.ops import gaussian

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def photometric_draws(key, b):
    """batch_photometric's per-sample draws, from its JAX key."""
    names = ("p_jitter", "brightness", "contrast", "saturation", "hue",
             "p_blur", "sigma")
    out = {k: [] for k in names}
    for k in jax.random.split(key, b):
        k_pj, k_j, k_pb, k_b = jax.random.split(k, 4)
        kb, kc, ks, kh = jax.random.split(k_j, 4)
        u = lambda kk, lo, hi: float(jax.random.uniform(kk, (), minval=lo,
                                                        maxval=hi))
        out["p_jitter"].append(u(k_pj, 0.0, 1.0))
        out["brightness"].append(u(kb, 0.75, 1.25))
        out["contrast"].append(u(kc, 0.75, 1.25))
        out["saturation"].append(u(ks, 0.75, 1.25))
        out["hue"].append(u(kh, -0.25, 0.25))
        out["p_blur"].append(u(k_pb, 0.0, 1.0))
        out["sigma"].append(u(jax.random.split(k_b)[0], 0.15, 1.15))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


def morph_draws(key, b, vector_size):
    """adv_morph_batch's draws, from its JAX key."""
    k_p, k_v = jax.random.split(key)
    return {"p": torch.tensor(float(jax.random.uniform(k_p))),
            "velocity": torch.from_numpy(np.array(jax.random.uniform(
                k_v, (b, *vector_size, 2), minval=-1.0, maxval=1.0)))}


# ------------------------------------------------------------- gaussian

@pytest.mark.parametrize("ks,sigma", [(7, 1.0), (3, 0.6)])
def test_gaussian_blur_2d(ks, sigma):
    x = np.random.RandomState(0).randn(2, 11, 9, 3).astype(np.float32)
    want = np.asarray(jgauss.gaussian_blur_2d(jnp.asarray(x), sigma, ks))
    got = gaussian.gaussian_blur_2d(_nchw(x), sigma, ks)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)
    assert gaussian.adv_morph_kernel_size(3, 1.0) \
        == jgauss.adv_morph_kernel_size(3, 1.0) == 7


def test_gaussian_blur_runtime_sigma_per_sample():
    rs = np.random.RandomState(1)
    x = rs.rand(3, 12, 10, 1).astype(np.float32)
    sigmas = np.array([0.15, 0.7, 1.15], np.float32)
    want = np.stack([np.asarray(jgauss.gaussian_blur_runtime_sigma(
        jnp.asarray(x[i:i + 1]), jnp.float32(s)))[0]
        for i, s in enumerate(sigmas)])
    got = gaussian.gaussian_blur_runtime_sigma(_nchw(x),
                                               torch.from_numpy(sigmas))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)


# ----------------------------------------------------------- photometric

@pytest.mark.parametrize("channels", [1, 3])
def test_batch_photometric(channels):
    b = 8
    x = np.random.RandomState(2).rand(b, 16, 16, channels).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jphoto.batch_photometric(key, jnp.asarray(x)))
    draws = photometric_draws(key, b)
    # the batch mixes samples with and without each augmentation
    for name in ("p_jitter", "p_blur"):
        fired = draws[name] > 0.5
        assert fired.any() and not fired.all(), name
    got = photometric.batch_photometric(_nchw(x), draws)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)


def test_batch_photometric_draws_from_a_generator():
    x = torch.rand(4, 1, 8, 8)
    gen = lambda: torch.Generator().manual_seed(0)
    a = photometric.batch_photometric(x, generator=gen())
    b = photometric.batch_photometric(
        x, photometric.draw_photometric(4, gen()))
    assert torch.equal(a, b) and a.shape == x.shape


# ---------------------------------------------------------------- morph

def test_unit_normalize():
    d = np.random.RandomState(4).uniform(-1, 1, (3, 4, 4, 2)) \
        .astype(np.float32)
    want = np.asarray(jmorph.unit_normalize(jnp.asarray(d)))
    got = morph.unit_normalize(torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_field_exponentiation():
    """A smooth field, as AdvMorph integrates (blurred, upsampled): the
    compositions amplify rounding by the field's Lipschitz constant."""
    rs = np.random.RandomState(5)
    yy, xx = np.meshgrid(np.linspace(0, 1, 12), np.linspace(0, 1, 10),
                         indexing="ij")
    duv = np.stack([np.stack([0.3 * np.sin(2 * np.pi * (f * yy + g * xx) + p)
                              for f, g, p in rs.rand(2, 3)], -1)
                    for _ in range(2)]).astype(np.float32)
    want = np.asarray(jmorph.field_exponentiation(jnp.asarray(duv)))
    got = morph.field_exponentiation(torch.from_numpy(duv))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("coarse_exp", [True, False])
def test_deformation_grid(coarse_exp):
    b, hw = 2, 32
    vel = np.random.RandomState(6).uniform(-1, 1, (b, 4, 4, 2)) \
        .astype(np.float32)
    jm = jmorph.AdvMorph((b, hw, hw, 1), (4, 4), coarse_exp=coarse_exp)
    want = np.asarray(jm.deformation_grid(
        jmorph.AdvMorphParams(jmorph.unit_normalize(jnp.asarray(vel)))))
    pm = morph.AdvMorph((b, 1, hw, hw), (4, 4), coarse_exp=coarse_exp)
    got = pm.deformation_grid(pm.init_params(torch.from_numpy(vel)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("coarse_exp", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_adv_morph_batch(coarse_exp, seed):
    """Key 0 warps the batch and key 3 leaves it as it is."""
    b, hw = 3, 32
    t = np.linspace(-1.0, 1.0, hw, dtype=np.float32)
    ph = np.random.RandomState(7).rand(b, 1, 1, 1).astype(np.float32)
    x = 0.5 + 0.5 * np.sin(0.5 * np.pi * (t[:, None, None] + 0.5 * t[:, None]
                                          + ph))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jmorph.adv_morph_batch(key, jnp.asarray(x),
                                             coarse_exp=coarse_exp))
    draws = morph_draws(key, b, (hw // 8, hw // 8))
    assert bool(draws["p"] > 0.5) == (seed == 0)
    got = morph.adv_morph_batch(_nchw(x), coarse_exp=coarse_exp,
                                draws=draws)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=2e-4)
    assert (np.abs(want - x).max() > 1e-2) == (seed == 0)


def test_adversarial_step():
    rs = np.random.RandomState(8)
    vel, grad = (rs.randn(2, 4, 4, 2).astype(np.float32) for _ in range(2))
    jm = jmorph.AdvMorph((2, 32, 32, 1), (4, 4))
    want = jm.adversarial_step(jmorph.AdvMorphParams(jnp.asarray(vel)),
                               jnp.asarray(grad), 0.5).velocity
    pm = morph.AdvMorph((2, 1, 32, 32), (4, 4))
    got = pm.adversarial_step(morph.AdvMorphParams(torch.from_numpy(vel)),
                              torch.from_numpy(grad), 0.5).velocity
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
