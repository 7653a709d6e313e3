"""U-Net, its layers and the ARCO heads of the PyTorch port against the
flax modules, with the flax weights carried across by
arco_torch.compat.from_flax (CPU, float32, TF32 off).

Tolerances: rtol 1e-4 / atol 1e-5 on one layer's activations and on the
BatchNorm running statistics (convolution summation order differs between
XLA:CPU and PyTorch's CPU kernels). Through the whole U-Net (19
convolutions, 18 batch norms, the 2x2 bottleneck normalizing over 8 values)
those differences grow to ~2e-5 on outputs of order 1, so the U-Net's
outputs are held to atol 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from arco_tpu.models import heads as jheads
from arco_tpu.models import layers as jlayers
from arco_tpu.models.unet2d import UNet as JaxUNet

from arco_torch.compat.from_flax import (
    feature_extractor_state_dict_from_flax,
    head_state_dict_from_flax, unet_state_dict_from_flax)
from arco_torch.models import heads, layers, net_factory

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
TOL = dict(rtol=1e-4, atol=1e-5)
DEEP_TOL = dict(rtol=1e-4, atol=5e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_batchnorm_running_stats_follow_flax():
    """flax momentum 0.9 is torch momentum 0.1, and the running variance
    takes the biased batch variance; normalization uses batch stats."""
    rs = np.random.RandomState(0)
    xs = [rs.randn(2, 3, 3, 4).astype(np.float32) * 3 + 1 for _ in range(2)]
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]),
                use_running_average=False)
    tbn = layers.BatchNorm2d(4)
    for x in xs:
        y, upd = bn.apply(v, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        np.testing.assert_allclose(_nhwc(tbn(_nchw(x))), np.asarray(y),
                                   **TOL)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(v["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]), **TOL)
    tbn.eval()
    y = bn.apply(v, jnp.asarray(xs[0]), use_running_average=True)
    np.testing.assert_allclose(_nhwc(tbn(_nchw(xs[0]))), np.asarray(y),
                               **TOL)


def test_conv_bn_act():
    x = np.random.RandomState(4).randn(2, 5, 5, 3).astype(np.float32)
    jm = jlayers.ConvBNAct(6)
    v = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    y, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tm = layers.ConvBNAct(3, 6)
    conv = v["params"]["Conv_0"]
    tm.conv.weight.data = torch.from_numpy(
        np.asarray(conv["kernel"]).transpose(3, 2, 0, 1).copy())
    tm.conv.bias.data = torch.from_numpy(np.asarray(conv["bias"]).copy())
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(y), **TOL)
    np.testing.assert_allclose(
        tm.bn.running_var.numpy(),
        np.asarray(upd["batch_stats"]["BatchNorm_0"]["var"]), **TOL)


def test_max_pool_and_bilinear_up():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 6, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(layers.max_pool(_nchw(x))),
                                  np.asarray(jlayers.max_pool(jnp.asarray(x))))
    up = jlayers.BilinearUp(5)
    v = up.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tup = layers.BilinearUp(3, 5)
    kern = np.asarray(v["params"]["Conv_0"]["kernel"])
    tup.conv1x1.weight.data = torch.from_numpy(
        kern.transpose(3, 2, 0, 1).copy())
    tup.conv1x1.bias.data = torch.from_numpy(
        np.asarray(v["params"]["Conv_0"]["bias"]).copy())
    np.testing.assert_allclose(_nhwc(tup(_nchw(x))),
                               np.asarray(up.apply(v, jnp.asarray(x))),
                               **TOL)


def test_dropout_uses_the_injected_keep_mask():
    x = torch.randn(2, 3, 4, 4)
    mask = torch.rand(2, 3, 4, 4) < 0.7
    y = layers.dropout(x, 0.3, mask)
    torch.testing.assert_close(y, torch.where(mask, x / 0.7, 0.0))
    assert layers.dropout(x, 0.3, mask, training=False) is x


@pytest.fixture(scope="module")
def unet_pair():
    rs = np.random.RandomState(2)
    xs = [rs.randn(2, 32, 32, 1).astype(np.float32) for _ in range(2)]
    jm = JaxUNet(in_chns=1, class_num=4, dropout=(0.0,) * 5)
    v = jm.init({"params": jax.random.PRNGKey(2),
                 "dropout": jax.random.PRNGKey(0)}, jnp.asarray(xs[0]))
    tm = net_factory("unet", in_chns=1, class_num=4, dropout=(0.0,) * 5)
    tm.load_state_dict(unet_state_dict_from_flax(_np(v["params"]),
                                                 _np(v["batch_stats"])))
    return jm, v, tm, xs


def test_unet_train_forwards_and_running_stats(unet_pair):
    """Two train-mode forwards thread the BN statistics; logits, the
    bottleneck latent, every decoder map and the stats agree."""
    jm, v, tm, xs = unet_pair
    params, stats = v["params"], v["batch_stats"]
    tm.train()
    for x in xs:
        (logits, latent, fmap), upd = jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        stats = upd["batch_stats"]
        t_logits, t_latent, t_fmap = tm(_nchw(x))
        np.testing.assert_allclose(_nhwc(t_logits), np.asarray(logits),
                                   **DEEP_TOL)
        np.testing.assert_allclose(_nhwc(t_latent), np.asarray(latent),
                                   **DEEP_TOL)
        assert [f.shape[1] for f in t_fmap] == [256, 128, 64, 32, 16]
        for a, b in zip(t_fmap, fmap):
            np.testing.assert_allclose(_nhwc(a), np.asarray(b), **DEEP_TOL)
    want = unet_state_dict_from_flax(_np(params), _np(stats))
    got = tm.state_dict()
    for name, w in want.items():
        if "running" in name:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       err_msg=name, **TOL)


def test_unet_eval_forward(unet_pair):
    jm, v, tm, xs = unet_pair
    tm.load_state_dict(unet_state_dict_from_flax(_np(v["params"]),
                                                 _np(v["batch_stats"])))
    tm.eval()
    logits, _, _ = jm.apply(v, jnp.asarray(xs[1]), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(tm(_nchw(xs[1]))[0]),
                                   np.asarray(logits), **DEEP_TOL)


def test_heads_composed_kernel_form():
    """FeatureExtractor (fea0..fea4 weights, composed-kernel form) and
    QRepresentation, channels-last [B, H, W, C] out."""
    rs = np.random.RandomState(3)
    fea_dim, out = (16, 8, 4, 4, 2), 34
    maps = [rs.randn(2, 2 ** (i + 1), 2 ** (i + 1), c).astype(np.float32)
            for i, c in enumerate(fea_dim)]
    jfe = jheads.FeatureExtractor(fea_dim=fea_dim, output_dim=out)
    vfe = jfe.init(jax.random.PRNGKey(3), [jnp.asarray(m) for m in maps])
    fused = jfe.apply(vfe, [jnp.asarray(m) for m in maps])
    jqr = jheads.QRepresentation(channels=out)
    vqr = jqr.init(jax.random.PRNGKey(4), fused)
    rep = jqr.apply(vqr, fused)

    fe = heads.FeatureExtractor(fea_dim, out)
    fe.load_state_dict(feature_extractor_state_dict_from_flax(
        _np(vfe["params"])))
    qr = heads.QRepresentation(out)
    qr.load_state_dict(head_state_dict_from_flax(
        _np(vqr["params"])))
    t_fused = fe([_nchw(m) for m in maps])
    t_rep = qr(t_fused)
    assert t_rep.is_contiguous() and t_rep.shape == (2, 32, 32, out)
    np.testing.assert_allclose(t_fused.detach().numpy(), np.asarray(fused),
                               **TOL)
    np.testing.assert_allclose(t_rep.detach().numpy(), np.asarray(rep),
                               **TOL)
