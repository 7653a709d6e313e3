"""The rest of the model zoo of the PyTorch port against the flax modules
(CPU, TF32 off): VoxResNet, the GAN modules (ResnetGenerator,
UnetGenerator, NLayerDiscriminator, ``gan_loss``, ``define_g`` /
``define_d``), the FC discriminators, VGG19Features and DeepClusterVGG16,
plus ``grid_sample_3d`` and the flax-"SAME" transposed conv.

Each model gets seeded random weights of flax's shapes (``jax.eval_shape``:
no flax init is compiled) and is held against JAX with them carried across
by arco_torch.compat.from_flax: the loader names every port tensor; the
eval-mode forward (with the statistics the train forward left), the
train-mode forward with JAX's dropout masks (read with
``flax.linen.intercept_methods``), the BatchNorm running statistics after
it, and the gradients of the mean square plus the mean of every output.
JAX runs in float64 (``jax.enable_x64``), the port in float64 against it
and in float32 against its own float64; the tolerances are stated where
they are defined. JAX's InstanceNorms take their statistics in float32
whatever the input; for these float64 runs a test-local copy of the same
math keeps the input's float64, as the port's InstanceNorm does
(``float64_instance_norms``). tests/test_torch_port_nnunet.py holds
nnU-Net and the tiled predictor with the same harness (``Pair``).

Where parity would break if the port were careless, the models below show
it: the GAN norms are flax's BatchNorm at momentum 0.99 and GroupNorm at
eps 1e-6 (``resnet_gen_batch``, ``resnet_gen_instance``); flax's "SAME"
transposed convs pad (2, 1) for kernel 3 (the ResnetGenerator's); the
ResnetBlock's second conv moves one index with dropout (the loader's
``use_dropout``); FCDiscriminator's and DeepClusterVGG16's first Linear
reads torch's (c, h, w) flatten, which the loader permutes from flax's
(h, w, c) (``fc_pool`` at 224x224 takes the 7x7 pool to a 2x2 map,
``dc_vgg16`` a 2x1 trunk map); VGG19Features stops at its deepest tap
(``vgg19_early``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from arco_tpu.models import discriminator as jdisc
from arco_tpu.models import gan as jgan
from arco_tpu.models import nnunet as jnn
from arco_tpu.models import vgg as jvgg
from arco_tpu.models import voxresnet as jvox
from arco_tpu.ops import interpolate as jinterp

from arco_torch.compat import from_flax
from arco_torch.models import discriminator, gan, vgg, voxresnet
from arco_torch.ops import interpolate

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

# float64, port against JAX, JAX's InstanceNorms in float64 (see
# float64_instance_norms); its resizes, VGG's L2 norm and flax's reductions
# of the running statistics still round to float32 (measured: outputs
# 9.9e-7 of their scale, VoxResNet's resizes; statistics 3.4e-8;
# gradients 3e-7 of the largest, VGG19Features')
F64_TOL = dict(rtol=1e-6, atol=1e-5)
STATS_F64_TOL = dict(rtol=1e-6, atol=1e-7)
F64_GRAD_TOL = dict(rtol=0.0, atol=2e-4)
# float32 against the port's own float64 (measured: outputs 4.7e-6 of the
# scale, statistics 2e-7, gradients 1.1e-3 of the largest: the instance-norm
# ResnetGenerator's, whose eps-1e-6 norms of 8x8 maps amplify rounding)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=0.0, atol=5e-3)


# ------------------------------------------------------------ the harness

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_port(x):
    """A channels-last array as the port takes it: [B, C, *spatial] for
    maps, as it is for [B, F]."""
    x = np.asarray(x)
    if x.ndim >= 4:
        x = np.moveaxis(x, -1, 1)
    return torch.from_numpy(np.ascontiguousarray(x))


def to_jax_layout(t):
    t = t.detach().double()
    return (t.movedim(1, -1) if t.ndim >= 4 else t).numpy().copy()


def flat_outputs(out):
    """A forward's tensors in order: tuples and lists flattened, dicts by
    sorted key."""
    if isinstance(out, dict):
        return flat_outputs([out[k] for k in sorted(out)])
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat_outputs(o)]
    return [out]


def close(got, want, rtol, atol, what="", scale=None):
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
def recording(keeps):
    """Record the keep-mask of every flax Dropout that draws, in call
    order (works under jit: the masks are returned by the traced
    function)."""

    def capture(next_fun, args, kwargs, context):
        mod = context.module
        if not (context.method_name == "__call__"
                and isinstance(mod, fnn.Dropout) and not mod.deterministic
                and mod.rate > 0):
            return next_fun(*args, **kwargs)
        keep = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs) != 0
        keeps.append(keep)
        x = args[0]
        return jnp.where(keep, x / (1.0 - mod.rate), 0).astype(x.dtype)

    with fnn.intercept_methods(capture):
        yield


def _normalized(x, eps):
    axes = tuple(range(1, x.ndim - 1))
    mean = jnp.mean(x, axis=axes, keepdims=True)
    var = jnp.var(x, axis=axes, keepdims=True)
    return (x - mean) / jnp.sqrt(var + eps)


class InstanceNorm(fnn.Module):
    """arco_tpu.models.voxresnet.InstanceNorm with its statistics in the
    input's dtype (the package's casts to float32)."""
    epsilon: float = 1e-5

    @fnn.compact
    def __call__(self, x):
        return _normalized(x, self.epsilon)


class InstanceNormAffine(fnn.Module):
    """arco_tpu.models.nnunet.InstanceNormAffine likewise; the same class
    name, so the same parameter paths."""
    epsilon: float = 1e-5

    @fnn.compact
    def __call__(self, x):
        scale = self.param("scale", fnn.initializers.ones, (x.shape[-1],))
        bias = self.param("bias", fnn.initializers.zeros, (x.shape[-1],))
        return _normalized(x, self.epsilon) * scale + bias


@contextlib.contextmanager
def float64_instance_norms():
    """JAX's InstanceNorms compute their statistics in float32 whatever
    the input (their policy for bf16 models), so inside a float64 model
    they round to float32, and over the few voxels of a deep map that
    rounding grows to 1e-3 of the gradients. The port keeps a float64
    input's statistics in float64. For the float64 comparisons the JAX
    models (which look the class up by name when they run) get the same
    math in the input's dtype."""
    saved = jnn.InstanceNormAffine, jvox.InstanceNorm
    jnn.InstanceNormAffine, jvox.InstanceNorm = InstanceNormAffine, \
        InstanceNorm
    try:
        yield
    finally:
        jnn.InstanceNormAffine, jvox.InstanceNorm = saved


def random_variables(jmodel, inputs, kw, seed=0):
    """Seeded numpy weights of the shapes flax's init would make: kernels
    ~ N(0, 1/fan_in), biases and shifts ~ N(0, 0.1^2), scales ~ 1 +
    N(0, 0.1^2); fresh BatchNorm statistics (mean 0, var 1)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *inputs, **kw))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "bias":
            v = 0.1 * rs.randn(*shape)
        elif name == "mean":
            v = np.zeros(shape)
        elif name == "var":
            v = np.ones(shape)
        else:
            raise AssertionError(f"unexpected variable {name}")
        return np.asarray(v, np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return v["params"], v.get("batch_stats", {})


class Spec:
    """A model of both frameworks: ``jfac(dtype)`` the flax module (its
    dtype field when it has one), ``tfac()`` the port's, ``inputs`` the
    seeded channels-last inputs; ``train_arg``: the flax call takes
    ``train``; ``masks``: the port's forward takes ``dropout_masks``;
    ``loader_kw``: for model_state_dict_from_flax; ``mode_free``: the
    model has neither dropout nor BatchNorm, so that JAX's train forward
    is its eval forward too (and is compiled once)."""

    def __init__(self, jfac, tfac, inputs, train_arg=True, masks=True,
                 loader_kw=None, mode_free=False):
        self.jfac, self.tfac, self.inputs = jfac, tfac, inputs
        self.train_arg, self.masks = train_arg, masks
        self.loader_kw = loader_kw or {}
        self.mode_free = mode_free or not train_arg


def _jax_loss(out):
    """The mean square plus the mean of every output (the mean keeps the
    gradient of L2-normalized taps, whose mean square is constant)."""
    return sum(jnp.mean(jnp.square(o)) + jnp.mean(o)
               for o in flat_outputs(out))


class Pair:
    """One model in both frameworks with the same weights. The JAX results
    (float64) of one jitted program: a train-mode forward with its dropout
    masks, statistics and the gradients of its loss, and an eval-mode
    forward with those statistics."""

    def __init__(self, spec: Spec):
        self.spec = spec
        jmodel = spec.jfac(jnp.float64)
        kw = lambda train: {"train": train} if spec.train_arg else {}
        with jax.enable_x64(True), float64_instance_norms():
            jx = [jnp.asarray(x, jnp.float64) for x in spec.inputs]
            self.params, self.stats = random_variables(jmodel, jx, kw(True))
            rngs = {"dropout": jax.random.PRNGKey(4)}

            def variables(params, stats):
                return {"params": params, **({"batch_stats": stats}
                                             if stats else {})}

            def train_loss(params, stats):
                keeps = []
                with recording(keeps):
                    out, upd = jmodel.apply(
                        variables(params, stats), *jx, **kw(True),
                        rngs=rngs, mutable=["batch_stats"])
                return _jax_loss(out), (out, upd.get("batch_stats", {}),
                                        keeps)

            def everything(params, stats):
                (_, (out, new_stats, keeps)), grads = jax.value_and_grad(
                    train_loss, has_aux=True)(params, stats)
                if spec.mode_free:
                    assert not (keeps or new_stats)
                    return out, new_stats, keeps, out, grads
                eval_out = jmodel.apply(variables(params, new_stats), *jx,
                                        **kw(False), rngs=rngs)
                return out, new_stats, keeps, eval_out, grads

            f64 = lambda t: jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), t)
            out, new_stats, keeps, eval_out, grads = jax.jit(everything)(
                f64(self.params), f64(self.stats))
            self.masks = [to_port(k) for k in keeps]
            self.j_train = [np.asarray(o) for o in flat_outputs(out)]
            self.new_stats = _np(new_stats)
            self.j_eval = [np.asarray(o) for o in flat_outputs(eval_out)]
            self.j_grads = {k: v.numpy() for k, v in self.load_dict(
                _np(grads), self.stats).items()}
        self.x = [to_port(x) for x in spec.inputs]
        self.model = spec.tfac()
        self.sd = self.load_dict(self.params, self.stats)
        self._train = None

    def load_dict(self, params, stats):
        return from_flax.model_state_dict_from_flax(params, stats,
                                                    **self.spec.loader_kw)

    def port(self, dtype, train: bool, stats=None):
        self.model.load_state_dict(self.sd if stats is None else
                                   self.load_dict(self.params, stats))
        return self.model.to(dtype).train(train)

    def call(self, model, dtype, masks=None):
        kw = {"dropout_masks": masks} if self.spec.masks else {}
        return flat_outputs(model(*[x.to(dtype) for x in self.x], **kw))

    def eval_outputs(self):
        """{dtype: [outputs in JAX's layout]} of the port's eval forward
        with the statistics of JAX's train forward."""
        outs = {}
        for dtype in (torch.float64, torch.float32):
            m = self.port(dtype, False, self.new_stats)
            with torch.no_grad():
                outs[dtype] = [to_jax_layout(t)
                               for t in self.call(m, dtype)]
        return outs

    def train_results(self):
        """{dtype: (outputs in JAX's layout, running statistics after the
        forward, gradients of the loss)} of the port's train forward with
        JAX's masks (computed once)."""
        if self._train is None:
            self._train = {}
            for dtype in (torch.float64, torch.float32):
                m = self.port(dtype, True)
                m.zero_grad()
                out = self.call(m, dtype, self.masks)
                stats = {k: v.double().numpy().copy() for k, v in
                         m.state_dict().items() if "running" in k}
                sum(o.square().mean() + o.mean() for o in out).backward()
                grads = {n: p.grad.double().numpy().copy()
                         for n, p in m.named_parameters()}
                self._train[dtype] = ([to_jax_layout(t) for t in out], stats,
                                      grads)
        return self._train


def check_loader_round_trip(pair):
    """Every port parameter and buffer is named by the loader, with its
    shape; the parameter counts agree."""
    want = pair.model.state_dict()
    assert sorted(pair.sd) == sorted(want)
    for k, v in want.items():
        assert tuple(pair.sd[k].shape) == tuple(v.shape), k
    n_flax = sum(np.size(v) for v in jax.tree_util.tree_leaves(pair.params))
    assert n_flax == sum(p.numel() for p in pair.model.parameters())


def check_outputs(outs, want, f32_tol=F32_TOL):
    assert len(outs[torch.float64]) == len(want)
    for i, (o64, o32, w) in enumerate(zip(outs[torch.float64],
                                          outs[torch.float32], want)):
        close(o64, w, what=f"float64 output {i}", **F64_TOL)
        close(o32, o64, what=f"float32 output {i}", **f32_tol)


def check_eval(pair, f32_tol=F32_TOL):
    check_outputs(pair.eval_outputs(), pair.j_eval, f32_tol)


def check_train_and_stats(pair, f32_tol=F32_TOL):
    res = pair.train_results()
    check_outputs({d: r[0] for d, r in res.items()}, pair.j_train, f32_tol)
    want = pair.load_dict(pair.params, pair.new_stats)
    stats = {d: r[1] for d, r in res.items()}
    for k, v in stats[torch.float64].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v, want[k].numpy(), err_msg=k,
                                   **STATS_F64_TOL)
        np.testing.assert_allclose(stats[torch.float32][k], v, err_msg=k,
                                   **STATS_TOL)


def check_gradients(pair, grad_tol=GRAD_TOL):
    """d(the mean square plus the mean of every output)/d(params) of the
    train forward with JAX's masks, each tensor within atol of the model's
    largest gradient."""
    grads = {d: r[2] for d, r in pair.train_results().items()}
    gmax = max(np.abs(g).max() for g in pair.j_grads.values())
    for name in grads[torch.float64]:
        close(grads[torch.float64][name], pair.j_grads[name], scale=gmax,
              what=f"float64 {name}", **F64_GRAD_TOL)
        close(grads[torch.float32][name], grads[torch.float64][name],
              scale=gmax, what=f"float32 {name}", **grad_tol)


# ------------------------------------------------------------ the models

def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _seg(b, *spatial, k, seed=2):
    """A softmax map [b, *spatial, k], as a discriminator sees one."""
    z = _x(b, *spatial, k, seed=seed)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


SPECS = {
    "voxresnet": lambda: Spec(
        lambda dt: jvox.VoxResNet(feature_chns=8, class_num=2, dtype=dt),
        lambda: voxresnet.VoxResNet(feature_chns=8, class_num=2),
        [_x(2, 32, 32, 16, 1)], mode_free=True),
    "resnet_gen_batch": lambda: Spec(
        lambda dt: jgan.ResnetGenerator(3, ngf=8, n_blocks=2,
                                        norm_type="batch", use_dropout=True),
        lambda: gan.ResnetGenerator(3, 3, ngf=8, n_blocks=2,
                                    norm_type="batch", use_dropout=True),
        [_x(2, 32, 32, 3)], loader_kw={"use_dropout": True}),
    "resnet_gen_instance": lambda: Spec(
        lambda dt: jgan.ResnetGenerator(2, ngf=8, n_blocks=2,
                                        norm_type="instance"),
        lambda: gan.ResnetGenerator(3, 2, ngf=8, n_blocks=2,
                                    norm_type="instance"),
        [_x(2, 32, 32, 3)], mode_free=True),
    # six levels, widths capped at ngf * 8 from level 3, dropout at level 4
    "unet_gen": lambda: Spec(
        lambda dt: jgan.UnetGenerator(2, num_downs=6, ngf=4,
                                      norm_type="batch", use_dropout=True),
        lambda: gan.UnetGenerator(3, 2, num_downs=6, ngf=4,
                                  norm_type="batch", use_dropout=True),
        [_x(2, 64, 64, 3)]),
    "nlayer_batch": lambda: Spec(
        lambda dt: jgan.NLayerDiscriminator(ndf=8, n_layers=3,
                                            norm_type="batch"),
        lambda: gan.NLayerDiscriminator(3, ndf=8, n_layers=3,
                                        norm_type="batch"),
        [_x(2, 64, 64, 3)], masks=False),
    "nlayer_instance_sigmoid": lambda: Spec(
        lambda dt: jgan.NLayerDiscriminator(ndf=8, n_layers=2,
                                            norm_type="instance",
                                            use_sigmoid=True),
        lambda: gan.NLayerDiscriminator(3, ndf=8, n_layers=2,
                                        norm_type="instance",
                                        use_sigmoid=True),
        [_x(2, 64, 64, 3)], masks=False, mode_free=True),
    "fc3d": lambda: Spec(
        lambda dt: jdisc.FC3DDiscriminator(num_classes=2, ndf=8, dtype=dt),
        lambda: discriminator.FC3DDiscriminator(num_classes=2, ndf=8),
        [_seg(2, 16, 16, 16, k=2), _x(2, 16, 16, 16, 1)]),
    "fc_pool": lambda: Spec(
        lambda dt: jdisc.FCDiscriminator(num_classes=4, ndf=8, dtype=dt),
        lambda: discriminator.FCDiscriminator(num_classes=4, ndf=8,
                                              img_size=224),
        [_seg(2, 224, 224, k=4), _x(2, 224, 224, 1)]),
    "fc_mean": lambda: Spec(
        lambda dt: jdisc.FCDiscriminator(num_classes=4, ndf=8, dtype=dt),
        lambda: discriminator.FCDiscriminator(num_classes=4, ndf=8,
                                              img_size=64),
        [_seg(2, 64, 64, k=4), _x(2, 64, 64, 1)]),
    "vgg19": lambda: Spec(
        lambda dt: jvgg.VGG19Features(("relu1_2", "relu3_2", "relu5_4"),
                                      normalize_features=True, dtype=dt),
        lambda: vgg.VGG19Features(("relu1_2", "relu3_2", "relu5_4"),
                                  normalize_features=True),
        [_x(2, 32, 32, 3)], train_arg=False, masks=False),
    "vgg19_early": lambda: Spec(
        lambda dt: jvgg.VGG19Features(("relu2_1",), dtype=dt),
        lambda: vgg.VGG19Features(("relu2_1",)),
        [_x(2, 32, 32, 3)], train_arg=False, masks=False),
    "dc_vgg16": lambda: Spec(
        lambda dt: jvgg.DeepClusterVGG16(num_classes=10, sobel=True,
                                         dtype=dt),
        lambda: vgg.DeepClusterVGG16(num_classes=10, sobel=True,
                                     img_size=(64, 32)),
        [_x(2, 64, 32, 3)], loader_kw={"spatial": (2, 1)}),
}


@pytest.fixture(scope="module", params=sorted(SPECS))
def pair(request):
    return Pair(SPECS[request.param]())


def test_loader_round_trip(pair):
    check_loader_round_trip(pair)


def test_eval_forward(pair):
    check_eval(pair)


def test_train_forward_and_running_stats(pair):
    check_train_and_stats(pair)


def test_gradients(pair):
    check_gradients(pair)


# the dropout sites that draw in a train forward: a ResnetBlock's one each,
# UnetGenerator's at level 4, the FC discriminators' three and two,
# DeepClusterVGG16's one
MASKS = {"resnet_gen_batch": 2, "unet_gen": 1, "fc3d": 3, "fc_pool": 2,
         "fc_mean": 2, "dc_vgg16": 1}


def test_dropout_masks_are_drawn_where_jax_draws(pair, request):
    name = request.node.callspec.params["pair"]
    assert len(pair.masks) == MASKS.get(name, 0)


@pytest.mark.parametrize("batch_norm,include_top", [
    (False, False), (False, True), (True, False)])
def test_deepcluster_vgg16_variants_load(batch_norm, include_top):
    """The loader fills every tensor of the VGG-16 variants without
    BatchNorm or top layer (flax's shapes at 64x64; ``dc_vgg16`` runs the
    numerics of the layers they share)."""
    jm = jvgg.DeepClusterVGG16(num_classes=10, batch_norm=batch_norm,
                               include_top=include_top)
    params, stats = random_variables(jm, [jnp.zeros((1, 64, 64, 3))],
                                     {"train": False})
    tm = vgg.DeepClusterVGG16(num_classes=10, batch_norm=batch_norm,
                              include_top=include_top, img_size=64)
    tm.load_state_dict(from_flax.model_state_dict_from_flax(params, stats))
    assert gan.get_n_parameters(tm) == jgan.get_n_parameters(params)


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_3d(padding_mode, align_corners):
    """The port's grid_sample_3d (NCDHW) against JAX's (channels-last) at a
    random grid reaching past every face, f32, atol 1e-5."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 6, 7, 5, 3).astype(np.float32)          # N D H W C
    grid = rs.uniform(-1.3, 1.3, (2, 4, 5, 3, 3)).astype(np.float32)
    want = np.asarray(jinterp.grid_sample_3d(
        jnp.asarray(x), jnp.asarray(grid), padding_mode=padding_mode,
        align_corners=align_corners))
    got = interpolate.grid_sample_3d(to_port(x), torch.from_numpy(grid),
                                     padding_mode=padding_mode,
                                     align_corners=align_corners)
    np.testing.assert_allclose(to_jax_layout(got), want, rtol=0, atol=1e-5)


def test_grid_sample_3d_is_trilinear_only():
    with pytest.raises(ValueError, match="nearest"):
        interpolate.grid_sample_3d(torch.zeros(1, 1, 2, 2, 2),
                                   torch.zeros(1, 1, 1, 1, 3), mode="nearest")


@pytest.mark.parametrize("kernel,stride", [(3, 2), (4, 2), (2, 2), (3, 1),
                                           (1, 2), (5, 3)])
def test_same_conv_transpose_matches_flax(kernel, stride):
    """SameConvTranspose2d against flax ConvTranspose(padding="SAME") with
    the kernel carried by the loader's flip, f64, atol 1e-10."""
    rs = np.random.RandomState(kernel * 10 + stride)
    x = rs.randn(2, 5, 6, 3)
    jm = fnn.ConvTranspose(4, (kernel, kernel), strides=(stride, stride),
                           padding="SAME", param_dtype=jnp.float64)
    p = {"kernel": rs.randn(kernel, kernel, 3, 4), "bias": rs.randn(4)}
    with jax.enable_x64(True):
        want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = gan.SameConvTranspose2d(3, 4, kernel, stride).double()
    tm.load_state_dict(from_flax._conv_transpose(p))
    got = to_jax_layout(tm(to_port(x)))
    assert got.shape == want.shape == (2, 5 * stride, 6 * stride, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("use_lsgan", [True, False])
@pytest.mark.parametrize("target_is_real", [True, False])
def test_gan_loss(use_lsgan, target_is_real):
    """gan_loss against JAX's on sigmoid outputs with values at the clip
    bounds, f32, rtol 1e-6."""
    p = _x(2, 1, 6, 6, seed=8)
    p = 1.0 / (1.0 + np.exp(-4 * p))
    p[0, 0, 0, :2] = (0.0, 1.0)
    want = float(jgan.gan_loss(jnp.asarray(p), target_is_real, use_lsgan))
    got = float(gan.gan_loss(torch.from_numpy(p), target_is_real, use_lsgan))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("which", ["resnet_9blocks", "resnet_6blocks",
                                   "unet_128", "unet_256"])
def test_define_g_counts_flax_parameters(which):
    """define_g builds the class JAX's does, with as many parameters
    (get_n_parameters), for both norms."""
    for norm in ("batch", "instance"):
        jm = jgan.define_g(3, 8, which, norm=norm)
        tm = gan.define_g(3, 3, 8, which, norm=norm)
        assert type(tm).__name__ == type(jm).__name__
        size = 128 if which != "unet_256" else 256
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
        assert gan.get_n_parameters(tm) == jgan.get_n_parameters(
            shapes["params"])


@pytest.mark.parametrize("which,n_layers", [("basic", 3), ("n_layers", 5)])
def test_define_d_counts_flax_parameters(which, n_layers):
    jm = jgan.define_d(8, which, n_layers, norm="batch")
    tm = gan.define_d(3, 8, which, n_layers, norm="batch")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3))))
    assert gan.get_n_parameters(tm) == jgan.get_n_parameters(
        shapes["params"])


def test_unknown_generator_and_discriminator_raise():
    with pytest.raises(NotImplementedError, match="not recognized"):
        gan.define_g(3, 3, 8, "unet_64")
    with pytest.raises(NotImplementedError, match="not recognized"):
        gan.define_d(3, 8, "pixel")
    with pytest.raises(NotImplementedError, match="not found"):
        gan.norm_layer("layer", 4)


def test_sobel_stem():
    """The fixed grayscale + Sobel stem against JAX's, f32, atol 1e-5."""
    x = _x(2, 9, 11, 3, seed=9)
    want = np.asarray(jvgg.sobel_stem(jnp.asarray(x)))
    got = to_jax_layout(vgg.sobel_stem(to_port(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
