"""nnU-Net (GenericUNet, 2D and 3D) and its tiled gaussian/mirror predictor
in the PyTorch port, against the flax/JAX package (CPU, TF32 off).

The models go through the harness of tests/test_torch_port_zoo_rest.py
(``Pair``: seeded weights of flax's shapes carried by
compat/from_flax.py, JAX in float64 with its InstanceNorms' statistics in
float64 as the port's are; eval and train forwards, dropout masks,
gradients), at the factory configurations (``initialize_network``:
2D at 64x64, 3D at 128x64x8, whose bottleneck is 2x1x2) and at the
option surface of tests/test_model_zoo.py: max pooling with linear
upsampling, deep supervision with ``upscale_logits``, dropout in the
localization path with JAX's masks; and a small 3D one with deep
supervision, biased heads and dropout in the context path only.

The tiled predictor: the gaussian, the window steps and the mirror
combinations equal JAX's; ``predict_tiled`` and ``predict_3d_via_2d`` give
the same label maps as JAX's and score maps within 1e-5 (atol), with a
deterministic predictor whose output depends on each window's position
and on its whole window batch (so the zero windows that fill the last
batch, and the padding of an image smaller than the patch, count), and
with carried nnU-Net weights (both frameworks in float64, accumulating in
float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.eval import tiled_predictor as jtiled
from arco_tpu.models import nnunet as jnn

from arco_torch.eval import tiled_predictor as tiled
from arco_torch.models import nnunet

from test_torch_port_zoo_rest import (Pair, Spec, check_eval,
                                      check_gradients,
                                      check_loader_round_trip,
                                      check_train_and_stats, random_variables,
                                      to_port)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

# float32 against the port's own float64: the InstanceNorms of the 2x2 and
# 2x1x2 bottlenecks amplify rounding (measured: outputs 4.9e-5 of their
# scale, the 2D factory model's; gradients 1.4e-4 of the largest, the 3D
# one's). Float64 against JAX: the harness's bounds (measured 1.1e-7 of
# the outputs, the linear upsampling's float32 in both; 2.6e-8 of the
# gradients)
F32_TOL = dict(rtol=1e-4, atol=2e-4)
GRAD_TOL = dict(rtol=0.0, atol=1e-3)
# the predictor's score maps (the tests' own bound)
SCORE_ATOL = 1e-5


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


_OPTIONS = dict(max_features=64, pool_kernels=((2, 2),) * 3,
                conv_kernels=((3, 3),) * 4, convolutional_pooling=False,
                convolutional_upsampling=False, deep_supervision=True,
                upscale_logits=True, dropout_p=0.5,
                dropout_in_localization=True)
_SMALL_3D = dict(base_num_features=8, max_features=16,
                 pool_kernels=((2, 2, 1), (2, 2, 2)),
                 conv_kernels=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                 deep_supervision=True, dropout_p=0.3,
                 seg_output_use_bias=True)

SPECS = {
    "factory_2d": lambda: Spec(
        lambda dt: jnn.initialize_network(4, threeD=False, dtype=dt),
        lambda: nnunet.initialize_network(4, threeD=False),
        [_x(2, 64, 64, 1)], mode_free=True),
    "factory_3d": lambda: Spec(
        lambda dt: jnn.initialize_network(2, threeD=True, dtype=dt),
        lambda: nnunet.initialize_network(2, threeD=True),
        [_x(1, 128, 64, 8, 1)], mode_free=True),
    "options_2d": lambda: Spec(
        lambda dt: jnn.GenericUNet(num_classes=3, dtype=dt, **_OPTIONS),
        lambda: nnunet.GenericUNet(num_classes=3, **_OPTIONS),
        [_x(2, 32, 32, 1)]),
    "ds_3d": lambda: Spec(
        lambda dt: jnn.GenericUNet(num_classes=2, dtype=dt, **_SMALL_3D),
        lambda: nnunet.GenericUNet(num_classes=2, **_SMALL_3D),
        [_x(2, 16, 16, 8, 1)]),
}
# the dropout sites that draw in a train forward: every block of the
# context path (and of the localization path when dropout_in_localization)
MASKS = {"factory_2d": 0, "factory_3d": 0, "options_2d": 14, "ds_3d": 6}


@pytest.fixture(scope="module", params=sorted(SPECS))
def pair(request):
    return Pair(SPECS[request.param]())


def test_loader_round_trip(pair):
    check_loader_round_trip(pair)


def test_eval_forward(pair):
    check_eval(pair, F32_TOL)


def test_train_forward_and_running_stats(pair):
    check_train_and_stats(pair, F32_TOL)


def test_gradients(pair):
    check_gradients(pair, GRAD_TOL)


def test_dropout_masks_are_drawn_where_jax_draws(pair, request):
    assert len(pair.masks) == MASKS[request.node.callspec.params["pair"]]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_structure_matches_flax(name):
    """The forward's structure (output count, the deep-supervision tuple,
    the latent's and the feature maps' shapes) against jax.eval_shape's;
    the port's ``latent_channels`` (which the pretrain heads read) is the
    latent's width."""
    spec = SPECS[name]()
    jm = spec.jfac(jnp.float32)
    x = jnp.zeros(spec.inputs[0].shape)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                       train=False))
    logits, latent, fmap = jax.eval_shape(
        lambda v: jm.apply(v, x, train=False), v)
    tm = spec.tfac().eval()
    with torch.no_grad():
        t_logits, t_latent, t_fmap = tm(to_port(np.zeros(x.shape,
                                                         np.float32)))
    assert isinstance(t_logits, tuple) == isinstance(logits, tuple)
    want = logits if isinstance(logits, tuple) else (logits,)
    got = t_logits if isinstance(t_logits, tuple) else (t_logits,)
    assert [tuple(t.movedim(1, -1).shape) for t in got] == \
        [w.shape for w in want]
    assert tuple(t_latent.movedim(1, -1).shape) == latent.shape
    assert [tuple(t.movedim(1, -1).shape) for t in t_fmap] == \
        [f.shape for f in fmap]
    assert tm.latent_channels == latent.shape[-1]


def test_off_lattice_input_fails_as_in_jax():
    """The 3D factory model needs H and W divisible by 64: at 112x112x80
    (LA's patch) both frameworks fail at a skip concatenation."""
    jm = jnn.initialize_network(2, threeD=True)
    x = jnp.zeros((1, 112, 112, 8, 1))
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    tm = nnunet.initialize_network(2, threeD=True)
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        with torch.no_grad():
            tm(torch.zeros(1, 1, 112, 112, 8))


# ------------------------------------------------------- tiled predictor

@pytest.mark.parametrize("patch", [(16, 16, 8), (128, 128, 80), (7, 9)])
def test_gaussian(patch):
    np.testing.assert_array_equal(tiled.get_gaussian(patch),
                                  jtiled.get_gaussian(patch))


@pytest.mark.parametrize("patch,image,step", [
    ((16, 16, 8), (40, 16, 9), 0.5), ((128, 128, 80), (128, 160, 96), 0.5),
    ((64, 64), (100, 65), 0.7), ((8, 8), (8, 8), 0.25)])
def test_window_steps(patch, image, step):
    assert tiled.compute_steps_for_sliding_window(patch, image, step) == \
        jtiled.compute_steps_for_sliding_window(patch, image, step)


def test_mirror_combinations():
    for axes in ((0, 1, 2), (0, 1), (2,), ()):
        assert tiled._mirror_axes_combinations(axes) == \
            jtiled._mirror_axes_combinations(axes)


class Field:
    """A deterministic predictor of K classes whose softmax depends on the
    voxel, its place in the window (a fixed random field) and the mean of
    the whole window batch: JAX's takes [B, *patch, 1], the port's [B, 1,
    *patch]."""

    def __init__(self, patch, k, seed=3):
        rs = np.random.RandomState(seed)
        self.c = rs.randn(k).astype(np.float32)
        self.d = rs.randn(k).astype(np.float32)
        self.w = rs.randn(k, *patch).astype(np.float32)

    def jax(self, b):
        x = b[..., 0]
        nd = x.ndim - 1
        shape = (1, -1) + (1,) * nd
        z = (x[:, None] * jnp.asarray(self.c).reshape(shape)
             + jnp.asarray(self.w)[None]
             + jnp.mean(b) * jnp.asarray(self.d).reshape(shape))
        return jnp.moveaxis(jax.nn.softmax(z, axis=1), 1, -1)

    def port(self, b):
        nd = b.ndim - 2
        shape = (1, -1) + (1,) * nd
        c, d, w = (torch.from_numpy(a).to(b.device)
                   for a in (self.c, self.d, self.w))
        z = b * c.view(shape) + w[None] + b.mean() * d.view(shape)
        return torch.softmax(z, dim=1)


def _check_prediction(got, want):
    lab, score = got
    j_lab, j_score = want
    np.testing.assert_array_equal(lab, np.asarray(j_lab))
    np.testing.assert_allclose(score.cpu().numpy(), np.asarray(j_score),
                               rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("use_gaussian,step,window_batch", [
    (True, 0.5, 2), (False, 0.5, 3), (True, 0.35, 4)])
def test_predict_tiled_field(use_gaussian, step, window_batch):
    """3D: an image smaller than the patch along Z (padded), windows that
    do not fill the last batch, all 8 mirror combinations."""
    patch, k = (16, 12, 8), 3
    field = Field(patch, k)
    image = _x(37, 21, 6, seed=4)
    want = jtiled.predict_tiled(field.jax, image, patch, k, step,
                                use_gaussian, window_batch=window_batch)
    got = tiled.predict_tiled(field.port, image, patch, k, step,
                              use_gaussian, window_batch=window_batch,
                              device="cpu")
    _check_prediction(got, want)


def test_predict_3d_via_2d_field():
    patch, k = (16, 16), 4
    field = Field(patch, k, seed=5)
    volume = _x(3, 40, 23, seed=6)
    want = jtiled.predict_3d_via_2d(field.jax, volume, patch, k,
                                    window_batch=3)
    got = tiled.predict_3d_via_2d(field.port, volume, patch, k,
                                  window_batch=3, device="cpu")
    assert got[1].shape == (k, 3, 40, 23)
    _check_prediction(got, want)


def _carried(jm, tm, x_shape):
    """Seeded flax weights of ``jm`` carried into ``tm`` (float64, eval):
    the JAX and the port softmax predictors."""
    from arco_torch.compat.from_flax import model_state_dict_from_flax
    with jax.enable_x64(True):
        params, stats = random_variables(
            jm, [jnp.zeros(x_shape, jnp.float64)], {"train": False}, seed=7)
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params)
    tm.load_state_dict(model_state_dict_from_flax(params, stats))
    tm.double().eval()

    @jax.jit
    def jax_predict(b):
        logits = jm.apply({"params": params}, b.astype(jnp.float64),
                          train=False)[0]
        return jax.nn.softmax(logits, axis=-1)

    def port_predict(b):
        with torch.no_grad():
            return torch.softmax(tm(b.double())[0], dim=1)
    return jax_predict, port_predict


def test_predict_tiled_nnunet_3d():
    kw = dict(base_num_features=4, max_features=16,
              pool_kernels=((2, 2, 1), (2, 2, 2)),
              conv_kernels=((3, 3, 1), (3, 3, 3), (3, 3, 3)))
    patch = (16, 16, 8)
    jm = jnn.GenericUNet(num_classes=3, dtype=jnp.float64, **kw)
    tm = nnunet.GenericUNet(num_classes=3, **kw)
    jax_predict, port_predict = _carried(jm, tm, (2,) + patch + (1,))
    image = _x(26, 19, 12, seed=8)
    with jax.enable_x64(True):
        want = jtiled.predict_tiled(jax_predict, image, patch, 3)
    got = tiled.predict_tiled(port_predict, image, patch, 3, device="cpu")
    _check_prediction(got, want)


def test_predict_3d_via_2d_nnunet_2d():
    kw = dict(base_num_features=4, max_features=16,
              pool_kernels=((2, 2),) * 2, conv_kernels=((3, 3),) * 3)
    patch = (16, 16)
    jm = jnn.GenericUNet(num_classes=4, dtype=jnp.float64, **kw)
    tm = nnunet.GenericUNet(num_classes=4, **kw)
    jax_predict, port_predict = _carried(jm, tm, (2,) + patch + (1,))
    volume = _x(2, 30, 17, seed=9)
    with jax.enable_x64(True):
        want = jtiled.predict_3d_via_2d(jax_predict, volume, patch, 4)
    got = tiled.predict_3d_via_2d(port_predict, volume, patch, 4,
                                  device="cpu")
    _check_prediction(got, want)
