"""The 3-D modules of the PyTorch port against the flax/JAX ones (CPU, f32,
TF32 off), at 32x32x16: V-Net and its layers, the trilinear and nearest
resizes, the fused heads, the 3-D mixing masks, the 5-D TPS warp, and the
contrastive loss's two-class edge.

The JAX weights are carried by arco_torch.compat.from_flax. The V-Net's two
dropout sites share one flax Dropout, so a forward draws two masks; they are
read from JAX (``jax_dropout_masks``) and handed to the port.

Tolerances: one layer, the resizes, the heads, the eval-mode V-Net and
the running statistics atol 1e-5 / rtol 1e-4 (summation order of XLA:CPU
against PyTorch's CPU kernels); the TPS warp atol 3e-5
(test_torch_port_losses.py's grid bound); masks, mixed batches and nearest
resizes exactly. The train-mode V-Net's outputs are held to atol 3e-4 on
values up to ~7: its BatchNorm normalizes the 2x2x1 bottleneck of a batch
of 2 over 8 values a channel, which amplifies f32 rounding, so JAX's logits
and the port's each lie ~1.2e-4 from a float64 forward of the same weights
and masks (up to 1.8e-4 apart on the decoder maps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from arco_tpu.augment import mixing as jmixing
from arco_tpu.augment import tps as jtps
from arco_tpu.losses import contrastive as jcontra
from arco_tpu.models import heads as jheads
from arco_tpu.models import layers as jlayers
from arco_tpu.models.factory import net_factory_3d as jax_net_factory_3d
from arco_tpu.ops import interpolate as jinterp

from arco_torch.augment import mixing, tps
from arco_torch.compat.from_flax import (
    feature_extractor_state_dict_from_flax, head_state_dict_from_flax,
    vnet_state_dict_from_flax)
from arco_torch.losses import contrastive
from arco_torch.models import heads, layers, net_factory_3d
from arco_torch.ops import interpolate

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=3e-4)
S = (32, 32, 16)


def ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def ndhwc(t):
    return t.detach().movedim(1, -1).numpy()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_dropout_masks(jmodel, variables, x_shape, key):
    """The keep-masks (x5, x9) that a train-mode forward of the flax V-Net
    draws with dropout key ``key``, as NCDHW bool tensors: each Dropout call
    is intercepted, run once on ones (the mask does not depend on the
    input) and replayed on its input."""
    masks = []

    def capture(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == \
                "__call__" and not mod.deterministic:
            x = args[0]
            keep = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
            masks.append(torch.from_numpy(np.moveaxis(np.asarray(keep), -1,
                                                      1).copy()))
            return jnp.where(keep, x / (1.0 - mod.rate), 0).astype(x.dtype)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(capture):
        jmodel.apply(variables, jnp.zeros(x_shape), train=True,
                     rngs={"dropout": key}, mutable=["batch_stats"])
    assert len(masks) == 2
    return masks


# ---------------------------------------------------------------- layers

def test_batchnorm3d_running_stats_follow_flax():
    rs = np.random.RandomState(0)
    xs = [rs.randn(2, 3, 3, 2, 4).astype(np.float32) * 3 + 1
          for _ in range(2)]
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]),
                use_running_average=False)
    tbn = layers.BatchNorm3d(4)
    for x in xs:
        y, upd = bn.apply(v, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        np.testing.assert_allclose(ndhwc(tbn(ncdhw(x))), np.asarray(y),
                                   **TOL)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(v["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]), **TOL)
    with layers.running_stats_frozen(tbn):
        tbn(ncdhw(xs[0]))
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]), **TOL)


def test_conv_bn_act_3d_relu():
    x = np.random.RandomState(4).randn(2, 5, 5, 4, 3).astype(np.float32)
    jm = jlayers.ConvBNAct(6, act="relu")
    v = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    y, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tm = layers.ConvBNAct(3, 6, nd=3, act="relu")
    conv = v["params"]["Conv_0"]
    tm.conv.weight.data = torch.from_numpy(
        np.asarray(conv["kernel"]).transpose(4, 3, 0, 1, 2).copy())
    tm.conv.bias.data = torch.from_numpy(np.asarray(conv["bias"]).copy())
    np.testing.assert_allclose(ndhwc(tm(ncdhw(x))), np.asarray(y), **TOL)
    np.testing.assert_allclose(
        tm.bn.running_var.numpy(),
        np.asarray(upd["batch_stats"]["BatchNorm_0"]["var"]), **TOL)


def test_conv_transpose_up_carries_the_flipped_kernel():
    """flax places an unflipped kernel; the port's torch weight is the flax
    kernel flipped in every spatial dim (compat/from_flax.py)."""
    from arco_torch.compat.from_flax import _conv_transpose
    x = np.random.RandomState(6).randn(2, 3, 4, 2, 5).astype(np.float32)
    jm = jlayers.ConvTransposeUp(7)
    v = jm.init(jax.random.PRNGKey(7), jnp.asarray(x))
    tm = layers.ConvTransposeUp(5, 7, nd=3)
    tm.load_state_dict(_conv_transpose(_np(v["params"]["ConvTranspose_0"])))
    np.testing.assert_allclose(ndhwc(tm(ncdhw(x))),
                               np.asarray(jm.apply(v, jnp.asarray(x))),
                               **TOL)


def test_net_factory_3d_ports_vnet_only():
    assert net_factory_3d("vnet").has_dropout
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        net_factory_3d("unet_3D")


# ----------------------------------------------------------------- V-Net

@pytest.fixture(scope="module")
def vnet_pair():
    rs = np.random.RandomState(2)
    x = rs.randn(2, *S, 1).astype(np.float32)
    jm = jax_net_factory_3d("vnet", in_chns=1, class_num=2)
    v = jm.init({"params": jax.random.PRNGKey(2),
                 "dropout": jax.random.PRNGKey(0)}, jnp.asarray(x))
    tm = net_factory_3d("vnet", in_chns=1, class_num=2)
    tm.load_state_dict(vnet_state_dict_from_flax(_np(v["params"]),
                                                 _np(v["batch_stats"])))
    return jm, v, tm, x


def test_vnet_train_forward_with_jax_dropout_masks(vnet_pair):
    """Logits, the five decoder maps (channels 128, 64, 32, 16, 16) and the
    BatchNorm running statistics after one train-mode forward."""
    jm, v, tm, x = vnet_pair
    key = jax.random.PRNGKey(9)
    masks = jax_dropout_masks(jm, v, x.shape, key)
    assert [tuple(m.shape) for m in masks] == [(2, 256, 2, 2, 1),
                                               (2, 16) + S]
    (logits, latent, fmap), upd = jm.apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"],
        rngs={"dropout": key})
    tm.train()
    t_logits, t_latent, t_fmap = tm(ncdhw(x), masks)
    np.testing.assert_allclose(ndhwc(t_logits), np.asarray(logits),
                               **TRAIN_TOL)
    np.testing.assert_allclose(ndhwc(t_latent), np.asarray(latent),
                               **TRAIN_TOL)
    assert [f.shape[1] for f in t_fmap] == [128, 64, 32, 16, 16]
    for a, b in zip(t_fmap, fmap):
        np.testing.assert_allclose(ndhwc(a), np.asarray(b), **TRAIN_TOL)
    want = vnet_state_dict_from_flax(_np(v["params"]),
                                     _np(upd["batch_stats"]))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        if "running" in name:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       err_msg=name, **TOL)


def test_vnet_eval_forward(vnet_pair):
    jm, v, tm, x = vnet_pair
    tm.load_state_dict(vnet_state_dict_from_flax(_np(v["params"]),
                                                 _np(v["batch_stats"])))
    tm.eval()
    logits, _, _ = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(ndhwc(tm(ncdhw(x))[0]),
                                   np.asarray(logits), **TOL)


def test_vnet_draws_its_masks_in_forward_order():
    """A forward without masks draws x5's then x9's from the generator,
    as draw_dropout_masks does; eval draws none."""
    tm = net_factory_3d("vnet", in_chns=1, class_num=2).train()
    x = torch.randn(1, 1, *S)
    drawn = tm.draw_dropout_masks(x.shape, torch.Generator().manual_seed(3))
    want = tm(x, drawn)[0]
    got = tm(x, generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(got, want)
    assert tm.eval().draw_dropout_masks(x.shape) == [None, None]


# ------------------------------------------------------- resize and heads

@pytest.mark.parametrize("align_corners", [True, False])
def test_trilinear_resize(align_corners):
    x = np.random.RandomState(3).randn(2, 4, 3, 5, 3).astype(np.float32)
    for out in ((8, 6, 10), (3, 2, 4)):
        want = jinterp.resize_bilinear(jnp.asarray(x), out,
                                       align_corners=align_corners)
        got = interpolate.resize_bilinear(ncdhw(x), out,
                                          align_corners=align_corners)
        np.testing.assert_allclose(ndhwc(got), np.asarray(want), atol=1e-6)


def test_nearest_resize_5d():
    x = np.random.RandomState(4).randint(0, 5, (2, 7, 6, 5, 3))
    for out in ((14, 3, 5), (4, 12, 9)):
        want = np.asarray(jinterp.resize_nearest(jnp.asarray(x), out))
        np.testing.assert_array_equal(
            ndhwc(interpolate.resize_nearest(ncdhw(x), out)), want)
        np.testing.assert_array_equal(interpolate.resize_nearest(
            torch.from_numpy(x), out, channels_last=True).numpy(), want)


def test_heads_3d():
    """FeatureExtractor (the V-Net's decoder maps fused to 16) and
    QRepresentation, channels-last [B, X, Y, Z, C] out."""
    rs = np.random.RandomState(5)
    fea_dim, out = (128, 64, 32, 16, 16), 16
    sizes = [(4, 4, 2), (8, 8, 4), (16, 16, 8), S, S]
    maps = [rs.randn(2, *s, c).astype(np.float32)
            for s, c in zip(sizes, fea_dim)]
    jfe = jheads.FeatureExtractor(fea_dim=fea_dim, output_dim=out)
    vfe = jfe.init(jax.random.PRNGKey(3), [jnp.asarray(m) for m in maps])
    fused = jfe.apply(vfe, [jnp.asarray(m) for m in maps])
    jqr = jheads.QRepresentation(channels=out)
    vqr = jqr.init(jax.random.PRNGKey(4), fused)
    rep = jqr.apply(vqr, fused)

    fe = heads.FeatureExtractor(fea_dim, out, nd=3)
    fe.load_state_dict(feature_extractor_state_dict_from_flax(
        _np(vfe["params"])))
    qr = heads.QRepresentation(out, nd=3)
    qr.load_state_dict(head_state_dict_from_flax(_np(vqr["params"])))
    assert fe.fea4.weight.shape == (16, 256, 1, 1, 1)
    t_fused = fe([ncdhw(m) for m in maps])
    t_rep = qr(t_fused)
    assert t_rep.is_contiguous() and t_rep.shape == (2, *S, out)
    np.testing.assert_allclose(t_fused.detach().numpy(), np.asarray(fused),
                               **TOL)
    np.testing.assert_allclose(t_rep.detach().numpy(), np.asarray(rep),
                               **TOL)


# ---------------------------------------------------------------- mixing

def cutout_boxes_3d(key, b, size):
    """(rw, x0, y0, zl, z0) as generate_cutout_mask_3d draws them from each
    of the batch's keys."""
    h, w, d = size
    out = []
    for k in jax.random.split(key, b):
        k2d, k_z, k_zl = jax.random.split(k, 3)
        k_w, k_x, k_y = jax.random.split(k2d, 3)
        rw = jax.random.randint(k_w, (), int(w / 2.0) + 1, w)
        rh = jnp.minimum(jnp.round(h * w / 2.0 / rw).astype(jnp.int32), h)
        x0 = jax.random.randint(k_x, (), 0, jnp.maximum(w - rw + 1, 1))
        y0 = jax.random.randint(k_y, (), 0, jnp.maximum(h - rh + 1, 1))
        zl = jax.random.randint(k_zl, (), max(d // 8, 1), max(d // 4, 2))
        z0 = jax.random.randint(k_z, (), 0, jnp.maximum(d - zl + 1, 1))
        out.append([int(rw), int(x0), int(y0), int(zl), int(z0)])
    return torch.tensor(out)


@pytest.mark.parametrize("mode", ["cutout", "cutmix", "classmix"])
def test_generate_unsup_data_3d(mode):
    rs = np.random.RandomState(5)
    b, nc = 3, 2
    data = rs.randn(b, *S, 1).astype(np.float32)
    target = rs.randint(0, nc, size=(b,) + S).astype(np.int32)
    target[1] = 0                                   # one class only
    logits = rs.rand(b, *S).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = jmixing.generate_unsup_data(key, jnp.asarray(data),
                                       jnp.asarray(target),
                                       jnp.asarray(logits), mode=mode,
                                       num_classes=nc)
    scores = torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (nc,)))
        for k in jax.random.split(key, b)]))
    got = mixing.generate_unsup_data(
        ncdhw(data), torch.from_numpy(target), torch.from_numpy(logits),
        mode=mode, num_classes=nc, boxes=cutout_boxes_3d(key, b, S),
        scores=scores)
    np.testing.assert_array_equal(ndhwc(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_cutout_mask_3d_from_jax_draws():
    key = jax.random.PRNGKey(14)
    want = np.stack([np.asarray(jmixing.generate_cutout_mask_3d(k, S))
                     for k in jax.random.split(key, 4)])
    got = mixing.generate_cutout_mask(cutout_boxes_3d(key, 4, S), S)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == 0).any() and (got == 1).any()


def test_native_cutout_boxes_3d_lie_in_range():
    gen = torch.Generator().manual_seed(0)
    boxes = mixing.draw_cutout_boxes(64, (32, 32, 80), generator=gen)
    rw, x0, y0, zl, z0 = boxes.unbind(1)
    assert ((17 <= rw) & (rw < 32)).all() and (x0 <= 32 - rw).all()
    assert ((10 <= zl) & (zl < 20)).all()
    assert ((0 <= z0) & (z0 <= 80 - zl)).all()


# ------------------------------------------------------------------- TPS

def test_rand_tps_apply_5d():
    """One 2D grid warps every depth slice: [B, C, X, Y, Z] against JAX's
    [B, X, Y, Z, C] warp from the same grid."""
    b = 2
    grid = tps.RandTPS(S[1], S[0], batch_size=b).reset(
        generator=torch.Generator().manual_seed(1))
    x = np.random.RandomState(6).randn(b, *S, 3).astype(np.float32)
    jt = jtps.RandTPS(S[1], S[0], batch_size=b)
    want = np.asarray(jt.apply(jnp.asarray(x), jnp.asarray(grid.numpy()),
                               padding_mode="zeros"))
    got = tps.RandTPS(S[1], S[0], batch_size=b).apply(
        ncdhw(x), grid, padding_mode="zeros")
    np.testing.assert_allclose(ndhwc(got), want, atol=3e-5)
    assert np.abs(want - x).max() > 1e-2


# --------------------------------------------- the two-class sampler edge

def test_contrastive_with_one_valid_class_is_zero():
    """Two classes, a randn bank, and a batch whose labels and masks hold
    class 0 only: fewer than 2 valid classes, so the loss is 0 in both
    packages (arco_tpu/losses/contrastive.py:288), and the bank takes the
    same enqueue."""
    rs = np.random.RandomState(7)
    b, nc, c = 2, 2, 8
    sp = (4, 4, 2)
    rep = rs.randn(b, *sp, c).astype(np.float32)
    rep_t = rs.randn(b, *sp, c).astype(np.float32)
    prob = np.asarray(jax.nn.softmax(jnp.asarray(
        rs.randn(b, *sp, nc).astype(np.float32) * 2), axis=-1))
    onehot = np.zeros((b, *sp, nc), np.float32)
    onehot[..., 0] = 1.0
    onehot_l = onehot.copy()
    onehot_l[1:] = 0
    ones = np.ones((b,) + sp, np.float32)
    is_lab = np.array([True, False])
    rank = np.asarray(jcontra.descending_rank(jnp.asarray(prob)))
    kw = dict(delta_n=0.97, num_queries=4, num_negatives=3, temp=0.5,
              current_class_threshold=0.3, enqueue_per_class=4)
    key = jax.random.PRNGKey(15)
    jbank = jcontra.create_memobank(nc, c, capacity=8, capacity_bg=8,
                                    init="randn",
                                    init_key=jax.random.PRNGKey(16))
    new_bank, want = jcontra.compute_contra_memobank_loss(
        key, jnp.asarray(rep), jnp.asarray(onehot), jnp.asarray(prob),
        jnp.asarray(rank), jnp.asarray(is_lab), jnp.asarray(onehot_l),
        jnp.asarray(ones), jnp.asarray(ones), jnp.asarray(rep_t), jbank,
        **kw)
    tbank = contrastive.create_memobank(nc, c, capacity=8, capacity_bg=8)
    tbank.data.copy_(torch.from_numpy(np.array(jbank.data)))
    k_anchor, k_neg, k_enq = jax.random.split(key, 3)
    from test_torch_port_losses import _uniforms
    draws = {"enq": _uniforms(k_enq, nc, 4), "anchor": _uniforms(k_anchor,
                                                                  nc, 4),
             "neg": _uniforms(k_neg, nc, 12)}
    t = torch.from_numpy
    _, got = contrastive.compute_contra_memobank_loss(
        t(rep), t(onehot), t(prob), t(rank), t(is_lab), t(onehot_l),
        t(ones), t(ones), t(rep_t), tbank, draws=draws, **kw)
    assert float(want) == float(got) == 0.0
    np.testing.assert_array_equal(tbank.ptr.numpy(), np.asarray(new_bank.ptr))
    np.testing.assert_allclose(tbank.data.numpy(), np.asarray(new_bank.data),
                               atol=1e-6)
