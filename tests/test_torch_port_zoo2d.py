"""The 2D model zoo of the PyTorch port against the flax modules (CPU, TF32
off): UNetSTEGO, UNetHAR, UNetDS, UNetCCT, UNetURPC, PNet2D and ENet at
64x64, batch 2 (EffiUNet, VisionTransformerSeg and SwinUnet in
test_torch_port_zoo2d_big.py, with these tests), narrow where the flax
class has the fields (HAR's ft_chns, PNet's num_filters, ViT's hidden /
num_layers / num_heads / mlp_dim, Swin's embed_dim / depths / num_heads /
window_size); plus the layers and the loaders of
arco_torch.compat.from_flax.

Each model gets seeded random weights of flax's shapes (no flax init is
compiled) and is held against JAX with them carried across: eval-mode and
train-mode forwards (every output, HAR's BatchNorm taps and the DS/CCT/URPC
heads included), the BatchNorm running statistics after the train forward,
and the gradients of a scalar loss of all outputs against ``jax.grad``.
JAX runs in float64 (``jax.enable_x64``, the modules' dtype float64), so
rounding cannot hide a difference in the function; the port's float64
results are held to JAX's, and its float32 results to its float64 ones.
The train-mode draws are JAX's: the keep-masks of every flax Dropout and
Swin DropPath, read with ``flax.linen.intercept_methods``
(``recording``), and the CCT/URPC perturbation draws, reproduced from the
keys that ``FeaturePerturbation`` is called with (read by wrapping its
static methods while JAX traces). The port takes them as arguments.

Where parity would break if the port were careless, the tests name it:
"SAME" strided convs pad asymmetrically in flax (EffiUNet's stem and 3x3 /
5x5 depthwise, TransUNet's 7x7 root and 3x3/s2 units:
``test_same_pad_stride2_matches_flax``); the tanh GELU and eps 1e-6
LayerNorm / GroupNorm (ViT, Swin); the flipped kernels of flax's
ConvTranspose (ENet); ENet's first-maximum unpooling on ties
(``test_max_pool_with_onehot_ties``); Swin's pad-before-roll windows
(its 48x48 model). The tolerances are stated where they are defined.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from arco_tpu.models import efficientunet as jeffi
from arco_tpu.models import enet as jenet
from arco_tpu.models import layers as jlayers
from arco_tpu.models import pnet as jpnet
from arco_tpu.models import swin_unet as jswin
from arco_tpu.models import transunet as jvit
from arco_tpu.models import unet2d as junet
from arco_tpu.models import unet2d_variants as jvar

from arco_torch.compat import from_flax
from arco_torch.models import (efficientunet, enet, layers, pnet, swin_unet,
                               transunet, unet2d, unet2d_variants)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

# float64, port against JAX: JAX's resize_bilinear, Swin's softmax and
# EffiUNet's squeeze-excite sigmoid compute in float32 inside a float64
# module (as the port's resize does), so both carry float32 rounding there
# (up to 3e-6 of the outputs' scale, 4e-9 on the running statistics and
# 7.2e-5 of the largest gradient measured, the latter UNetSTEGO's, whose
# dropout-0.5 layers normalize 4x4 maps)
F64_TOL = dict(rtol=1e-6, atol=1e-5)
STATS_F64_TOL = dict(rtol=1e-6, atol=1e-7)
F64_GRAD_TOL = dict(rtol=0.0, atol=2e-4)
# float32 against the port's own float64 (measured: eval 3.2e-5 and train
# 6.8e-5 of the scale, statistics 1.8e-6, gradients 1.8e-3 of the largest)
EVAL_TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=1e-4, atol=2e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=0.0, atol=5e-3)
# ViT's weight-standardized root conv: the standardization's backward takes
# the mean and the scale direction out of the gradient, a cancellation
# that loses float32 digits (1.1e-2 of the largest gradient measured for
# the port; JAX's float32 gradient lies 2.5e-2 from the float64 one)
GRAD_TOL_STDCONV = dict(rtol=0.0, atol=2e-2)


# ------------------------------------------------------------ the models

def _vit_kw():
    return dict(hidden=32, num_layers=2, num_heads=2, mlp_dim=64)


# 48x48: a 12x12 first stage padded to 16 under window 8 and shifted by 4
# (pad before roll), then 6x6 and 3x3 stages whose window clamps to the map,
# unshifted; dropout and drop path on, an absolute position embedding and
# explicit decoder depths
SWIN = dict(embed_dim=8, depths=(2, 2, 2), num_heads=(1, 2, 2),
            window_size=8, depths_decoder=(2, 1, 2), drop_rate=0.1,
            ape=True, drop_path_rate=0.2)

# name -> (flax module of a dtype, port module, input size, whether the
# port keeps its maps channels-last inside: then its masks stay NHWC)
MODELS = {
    "unet_stego": (lambda dt: jvar.UNetSTEGO(class_num=4, dtype=dt),
                   lambda: unet2d_variants.UNetSTEGO(class_num=4), 64,
                   False),
    "unet_har": (lambda dt: jvar.UNetHAR(class_num=4,
                                         ft_chns=(8, 8, 16, 16, 32),
                                         dtype=dt),
                 lambda: unet2d_variants.UNetHAR(
                     class_num=4, ft_chns=(8, 8, 16, 16, 32)), 64, False),
    "unet_ds": (lambda dt: junet.UNetDS(class_num=4, dtype=dt),
                lambda: unet2d.UNetDS(class_num=4), 64, False),
    "unet_cct": (lambda dt: junet.UNetCCT(class_num=4, dtype=dt),
                 lambda: unet2d.UNetCCT(class_num=4), 64, False),
    "unet_urpc": (lambda dt: junet.UNetURPC(class_num=4, dtype=dt),
                  lambda: unet2d.UNetURPC(class_num=4), 64, False),
    "pnet": (lambda dt: jpnet.PNet2D(num_classes=4, num_filters=16,
                                     dtype=dt),
             lambda: pnet.PNet2D(num_classes=4, num_filters=16), 64, False),
    "enet": (lambda dt: jenet.ENet(num_classes=4, dtype=dt),
             lambda: enet.ENet(num_classes=4), 64, False),
    "efficient_unet": (lambda dt: jeffi.EffiUNet(num_classes=4, dtype=dt),
                       lambda: efficientunet.EffiUNet(num_classes=4), 64,
                       False),
    "ViT_Seg": (lambda dt: jvit.VisionTransformerSeg(num_classes=4,
                                                     dtype=dt, **_vit_kw()),
                lambda: transunet.VisionTransformerSeg(
                    img_size=64, num_classes=4, **_vit_kw()), 64, False),
    "swin_unet": (lambda dt: jswin.SwinUnet(num_classes=4, dtype=dt,
                                            **SWIN),
                  lambda: swin_unet.SwinUnet(img_size=48, num_classes=4,
                                             **SWIN), 48, True),
}
# the three large models are held in test_torch_port_zoo2d_big.py, so
# that pytest-xdist runs the two halves side by side
BIG = ("efficient_unet", "ViT_Seg", "swin_unet")
NAMES = [n for n in MODELS if n not in BIG]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(x), -1, 1)))


def to_nhwc(t):
    return t.detach().movedim(1, -1).double().numpy().copy()


def flat_outputs(out):
    """A forward's outputs as one flat list (nested lists flattened)."""
    flat = []
    for o in out:
        flat += flat_outputs(o) if isinstance(o, (list, tuple)) else [o]
    return flat


def _close(got, want, rtol, atol, what="", scale=None):
    """|got - want| <= atol * scale + rtol * |want|, ``scale`` max|want|
    unless given."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want) - rtol * np.abs(want)
    assert err.max() <= atol * scale, \
        f"{what}: max err {np.abs(got - want).max():.3g} of scale " \
        f"{scale:.3g}"


@contextlib.contextmanager
def perturbation_keys(log):
    """Record (kind, key, shape) of every FeaturePerturbation call."""
    fp = jlayers.FeaturePerturbation
    saved = {k: fp.__dict__[k] for k in ("feature_noise", "dropout",
                                         "feature_dropout")}
    for kind, fn in saved.items():
        def wrapped(rng, x, *a, _kind=kind, _fn=fn.__func__, **kw):
            log.append((_kind, rng, x.shape))
            return _fn(rng, x, *a, **kw)
        setattr(fp, kind, staticmethod(wrapped))
    try:
        yield
    finally:
        for kind, fn in saved.items():
            setattr(fp, kind, fn)


def perturbation_draws(log, keys):
    """The port's draws of the recorded FeaturePerturbation calls (``log``
    of (kind, key, shape), ``keys`` their concrete values), by kind in call
    order, as FeaturePerturbation draws them."""
    out = {"feature_noise": [], "dropout": [], "feature_dropout": []}
    for (kind, _, shape), rng in zip(log, keys):
        if kind == "feature_noise":
            d = nchw(jax.random.uniform(rng, shape, minval=-0.3, maxval=0.3))
        elif kind == "dropout":
            d = nchw(jax.random.bernoulli(rng, 0.7, shape))
        else:
            d = torch.from_numpy(np.asarray(jax.random.uniform(
                rng, (shape[0],), minval=0.7, maxval=0.9)))
        out[kind].append(d)
    return out


@contextlib.contextmanager
def recording(keeps, log):
    """Record the keep-mask of every flax Dropout and Swin DropPath call
    that draws (``keeps``, in call order; a DropPath's as [B, 1, 1, 1]) and
    every FeaturePerturbation call (``log``). Works under jit: the
    recorded arrays are returned by the traced function."""

    def capture(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        if isinstance(mod, fnn.Dropout) and not mod.deterministic \
                and mod.rate > 0:
            keep = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs) != 0
        elif isinstance(mod, jswin.DropPath) and mod.rate > 0 \
                and not args[1]:
            keep = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs) != 0
            keep = keep[:, :1, :1, :1]
        else:
            return next_fun(*args, **kwargs)
        keeps.append(keep)
        x = args[0]
        return jnp.where(keep, x / (1.0 - mod.rate), 0).astype(x.dtype)

    with fnn.intercept_methods(capture), perturbation_keys(log):
        yield


def port_masks(keeps, channels_last_inside: bool):
    """Recorded keep-masks as the port's models take them: NCHW for 4-D
    maps unless the port keeps the map channels-last."""
    out = []
    for k in keeps:
        k = np.asarray(k)
        if k.ndim == 4 and not channels_last_inside:
            k = np.moveaxis(k, -1, 1)
        out.append(torch.from_numpy(np.array(k, copy=True)))
    return out


def _port_call(model, name, x, masks=None, draws=None):
    if name == "unet_cct":
        perturb = [draws["feature_noise"], draws["dropout"],
                   draws["feature_dropout"]] if draws else None
        return model(x, masks, None, perturb=perturb)
    if name == "unet_urpc" and draws:
        return model(x, masks, None, noise=draws["feature_noise"])
    return model(x, masks)


def _jax_loss(out):
    return sum(jnp.mean(jnp.square(o)) for o in flat_outputs(out))


def _to_jax_layout(t):
    """A port output in JAX's layout (4-D maps channels-last)."""
    return t.detach().double().numpy().copy() if t.ndim != 4 \
        else to_nhwc(t)


def random_variables(jmodel, x, seed=0):
    """Seeded numpy weights of the shapes flax's init would make (read with
    ``jax.eval_shape``, so nothing is compiled): kernels ~ N(0, 1/fan_in),
    biases, BatchNorm/LayerNorm shifts and HAR's beta ~ N(0, 0.1^2),
    scales and gamma ~ 1 + N(0, 0.1^2), PReLU slopes 0.25 + N(0, 0.05^2),
    position embeddings and bias tables ~ N(0, 0.3^2); fresh BatchNorm
    statistics (mean 0, var 1)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
         "perturb": jax.random.PRNGKey(0)}, x, train=True))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "gamma"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "alpha":
            v = 0.25 + 0.05 * rs.randn(*shape)
        elif name in ("bias", "beta"):
            v = 0.1 * rs.randn(*shape)
        elif name == "mean":
            v = np.zeros(shape)
        elif name == "var":
            v = np.ones(shape)
        else:                       # embeddings, bias tables
            v = 0.3 * rs.randn(*shape)
        return np.asarray(v, np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return v["params"], v.get("batch_stats", {})


class Pair:
    """One model in both frameworks with the same weights: JAX in float64
    (``jax.enable_x64``, the module's dtype float64), the port in float64
    and float32. The JAX results of one jitted program: a train-mode
    forward (with its draws), an eval-mode forward with the statistics
    that forward left (so that they are not the identity) and the
    gradients of the train forward's loss."""

    def __init__(self, name):
        jfac, tfac, hw, cl = MODELS[name]
        self.name = name
        x = np.random.RandomState(1).randn(2, hw, hw, 1).astype(np.float32)
        jmodel = jfac(jnp.float64)
        with jax.enable_x64(True):
            jx = jnp.asarray(x, jnp.float64)
            self.params, self.stats = random_variables(jmodel, jx)
            self._run_jax(jmodel, jx, cl)
        self.x = nchw(x)
        self.model = tfac()
        self.sd = from_flax.model_state_dict_from_flax(self.params,
                                                       self.stats)

    def _run_jax(self, jmodel, jx, cl):
        rngs = {"dropout": jax.random.PRNGKey(4),
                "perturb": jax.random.PRNGKey(5)}
        logs = ([], [])

        def train_apply(params, stats):
            v = {"params": params}
            if stats:
                v["batch_stats"] = stats
            return jmodel.apply(v, jx, train=True, rngs=rngs,
                                mutable=["batch_stats"])

        def everything(params, stats):
            keeps = []
            with recording(keeps, logs[0]):
                out, upd = train_apply(params, stats)
            new_stats = upd.get("batch_stats", {})
            v = {"params": params}
            if stats:
                v["batch_stats"] = new_stats
            with recording([], logs[1]):
                eval_out = jmodel.apply(v, jx, train=False, rngs=rngs)
            # the same keys draw the same masks as the recorded forward
            grads = jax.grad(lambda p: _jax_loss(train_apply(p, stats)[0]))(
                params)
            return (out, new_stats, keeps, [r for _, r, _ in logs[0]],
                    eval_out, [r for _, r, _ in logs[1]], grads)

        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t)
        args = (f64(self.params), f64(self.stats))
        out, new_stats, keeps, keys, eval_out, eval_keys, grads = jax.jit(
            everything)(*args)
        self.masks = port_masks(keeps, cl)
        self.draws = perturbation_draws(logs[0], keys)
        self.eval_draws = perturbation_draws(logs[1], eval_keys)
        self.j_train = [np.asarray(o) for o in flat_outputs(out)]
        self.new_stats = _np(new_stats)
        self.j_eval = [np.asarray(o) for o in flat_outputs(eval_out)]
        self.j_grads = {k: v.numpy() for k, v in
                        from_flax.model_state_dict_from_flax(
                            _np(grads), self.stats).items()}

    def port(self, dtype, train: bool, stats=None):
        sd = self.sd if stats is None else \
            from_flax.model_state_dict_from_flax(self.params, stats)
        self.model.load_state_dict(sd)
        return self.model.to(dtype).train(train)

    def call(self, model, dtype, masks=None, draws=None):
        if draws:
            draws = {k: [d.to(dtype) if d.is_floating_point() else d
                         for d in v] for k, v in draws.items()}
        return flat_outputs(_port_call(model, self.name, self.x.to(dtype),
                                       masks, draws))

    def forward(self, train: bool):
        """{dtype: [outputs in JAX's layout]} of the port's eval (train
        False, with the train forward's statistics) or train forward, and
        for train its running statistics after the forward."""
        outs, stats = {}, {}
        for dtype in (torch.float64, torch.float32):
            m = self.port(dtype, train, None if train else self.new_stats)
            with torch.no_grad():
                o = self.call(m, dtype, self.masks if train else None,
                              self.draws if train else self.eval_draws)
            outs[dtype] = [_to_jax_layout(t) for t in o]
            stats[dtype] = {k: v.double().numpy().copy() for k, v in
                            m.state_dict().items() if "running" in k}
        return outs, stats

    def gradients(self):
        grads = {}
        for dtype in (torch.float64, torch.float32):
            m = self.port(dtype, True)
            m.zero_grad()
            sum(o.square().mean() for o in self.call(
                m, dtype, self.masks, self.draws)).backward()
            grads[dtype] = {n: p.grad.double().numpy().copy()
                            for n, p in m.named_parameters()}
        return grads


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    return Pair(request.param)


def test_loader_round_trip(pair):
    """Every port parameter and buffer is named by the loader, with its
    shape; nothing is left over (load_state_dict is strict)."""
    got = pair.sd
    want = pair.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    n_flax = sum(np.size(v) for v in jax.tree_util.tree_leaves(pair.params))
    assert n_flax == sum(p.numel() for p in pair.model.parameters())


def _check_outputs(outs, want, f32_tol):
    assert len(outs[torch.float64]) == len(want)
    for i, (o64, o32, w) in enumerate(zip(outs[torch.float64],
                                          outs[torch.float32], want)):
        _close(o64, w, what=f"float64 output {i}", **F64_TOL)
        _close(o32, o64, what=f"float32 output {i}", **f32_tol)


def test_eval_forward(pair):
    outs, _ = pair.forward(train=False)
    _check_outputs(outs, pair.j_eval, EVAL_TOL)


def test_train_forward_and_running_stats(pair):
    outs, stats = pair.forward(train=True)
    _check_outputs(outs, pair.j_train, TRAIN_TOL)
    want = from_flax.model_state_dict_from_flax(pair.params, pair.new_stats)
    for k, v in stats[torch.float64].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v, want[k].numpy(), err_msg=k,
                                   **STATS_F64_TOL)
        np.testing.assert_allclose(stats[torch.float32][k], v, err_msg=k,
                                   **STATS_TOL)


def test_gradients(pair):
    """d(sum of the mean squares of every output)/d(params) of the train
    forward with JAX's draws: the port's float64 gradient against
    jax.grad, its float32 one against its float64 one; each tensor within
    atol of the model's largest gradient."""
    grads = pair.gradients()
    gmax = max(np.abs(g).max() for g in pair.j_grads.values())
    for name in grads[torch.float64]:
        _close(grads[torch.float64][name], pair.j_grads[name], scale=gmax,
               what=f"float64 {name}", **F64_GRAD_TOL)
        _close(grads[torch.float32][name], grads[torch.float64][name],
               scale=gmax, what=f"float32 {name}",
               **(GRAD_TOL_STDCONV if pair.name == "ViT_Seg" else GRAD_TOL))


# ---------------------------------------------------------------- layers

def test_max_pool_with_onehot_ties():
    """Ties (a ReLU map of mostly zeros, and equal pairs) pick the first
    maximum in window order, as JAX's argmax; the unpooling places each
    value there; the pooled value's gradient splits among ties as JAX's
    max does."""
    rs = np.random.RandomState(3)
    x = np.maximum(rs.randn(2, 6, 8, 3), 0).astype(np.float32)
    x[0, 0, 0, :] = x[0, 0, 1, :] = x[0, 1, 1, :] = 2.0
    jp, joh = jenet.max_pool_with_onehot(jnp.asarray(x))
    tp, toh = enet.max_pool_with_onehot(nchw(x))
    np.testing.assert_array_equal(to_nhwc(tp), np.asarray(jp))
    np.testing.assert_array_equal(toh.permute(0, 2, 3, 1, 4).numpy(),
                                  np.asarray(joh))
    y = rs.randn(*jp.shape).astype(np.float32)
    np.testing.assert_array_equal(
        to_nhwc(enet.max_unpool(nchw(y), toh)),
        np.asarray(jenet.max_unpool(jnp.asarray(y), joh)))
    jg = jax.grad(lambda v: jenet.max_pool_with_onehot(v)[0].sum())(
        jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    enet.max_pool_with_onehot(xt)[0].sum().backward()
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(jg), atol=1e-7)


@pytest.mark.parametrize("kernel,size", [(3, 16), (5, 16), (7, 64), (3, 15),
                                         (1, 16)])
def test_same_pad_stride2_matches_flax(kernel, size):
    """flax "SAME" with stride 2 pads (0, 1) / (1, 2) / (2, 3) on even
    sizes; padding=k // 2 would shift every window."""
    rs = np.random.RandomState(kernel + size)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    conv = fnn.Conv(4, (kernel, kernel), strides=(2, 2), padding="SAME")
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tconv = layers.SameConv2d(3, 4, kernel, stride=2)
    tconv.load_state_dict(from_flax._conv(_np(v["params"])))
    _close(to_nhwc(tconv(nchw(x))), conv.apply(v, jnp.asarray(x)),
           **EVAL_TOL)


def test_std_conv_standardizes_over_flax_axes():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 16, 16, 6).astype(np.float32)
    conv = jvit.StdConv(8, (3, 3), strides=(2, 2), padding="SAME",
                        use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    t = transunet.StdConv(6, 8, 3, stride=2)
    t.load_state_dict(from_flax._conv(_np(v["params"])))
    _close(to_nhwc(t(nchw(x))), conv.apply(v, jnp.asarray(x)), **EVAL_TOL)


def test_feature_perturbations_with_jax_draws():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 5, 6, 4).astype(np.float32)
    fp, tp = jlayers.FeaturePerturbation, layers.FeaturePerturbation
    key = jax.random.PRNGKey(9)
    log = [("feature_noise", key, x.shape), ("dropout", key, x.shape),
           ("feature_dropout", key, x.shape)]
    d = perturbation_draws(log, [key] * 3)
    _close(to_nhwc(tp.feature_noise(nchw(x), noise=d["feature_noise"][0])),
           fp.feature_noise(key, jnp.asarray(x)), **EVAL_TOL)
    _close(to_nhwc(tp.dropout(nchw(x), keep=d["dropout"][0])),
           fp.dropout(key, jnp.asarray(x)), **EVAL_TOL)
    _close(to_nhwc(tp.feature_dropout(nchw(x), u=d["feature_dropout"][0])),
           fp.feature_dropout(key, jnp.asarray(x)), **EVAL_TOL)


def test_mlp2():
    x = np.random.RandomState(7).randn(3, 5).astype(np.float32)
    m = jlayers.MLP2(hidden=6, out=4)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    t = layers.MLP2(5, 6, 4)
    t.load_state_dict({f"{i}.{k}": w for i in range(2) for k, w in
                       from_flax._dense(_np(v["params"][f"Dense_{i}"]))
                       .items()})
    _close(t(torch.from_numpy(x)).detach().numpy(),
           m.apply(v, jnp.asarray(x)), **EVAL_TOL)


@pytest.mark.parametrize("hw,ws,shift", [(8, 4, 2), (6, 3, 1)])
def test_swin_index_and_mask(hw, ws, shift):
    np.testing.assert_array_equal(swin_unet.relative_position_index(ws),
                                  jswin.relative_position_index(ws))
    np.testing.assert_array_equal(swin_unet.shift_mask(hw, hw, ws,
                                                       shift).numpy(),
                                  np.asarray(jswin.shift_mask(hw, hw, ws,
                                                              shift)))
