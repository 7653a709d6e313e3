"""The port's initial weights against the JAX package's initializers.

Every ``arco_tpu`` module draws flax's defaults (``lecun_normal`` kernels:
a unit normal truncated at +-2, divided by 0.8796, times 1/sqrt(fan-in);
zero biases) except where it sets a parameter itself (norms at ones /
zeros, ENet's PReLU slope 0.25, Swin's and ViT's ``normal(0.02)`` tables,
the 3-D attention gate's psi bias 3.0 / 10.0). The port's factories and
head builders redraw their modules the same way (``models/init.py``).

JAX's draws here: each parameter and batch statistic that a module's
``init`` creates is drawn by the very initializer JAX hands it, at its
shape, traced with ``jax.eval_shape`` (no forward is compiled) and drawn
in one jitted program from folds of an ``rbg`` key (its compile is about
half of threefry's); the values differ from ``model.init``'s, the
distributions are JAX's. A flax ``init`` of the whole zoo would take
minutes here (16-33 s a model for the U-Net and V-Net), so:

- whole models against JAX, key for key through ``compat/from_flax.py``:
  the gate's 2D U-Net (also the natural gate's, at 3 input channels) and
  the 3D gate's V-Net, the ARCO heads (2D at 496 channels, 3D fused to 16)
  and the ISD heads (2D and 3D);
- each layer kind against its JAX module, at three seeds, with its fan-in
  checked directly: conv 2D / 3D, grouped and depthwise conv, transposed
  conv 2D / 3D, dense, ViT's attention projections, Swin's window
  attention (dense layers and the bias table), ENet's PReLU, the TORR
  attention gate's psi bias (sigmoid and softmax);
- every other key of ``net_factory``, ``net_factory_3d`` and the natural
  models (DeepLab-v2 / v3+ at ResNet-50), port only: built through its
  factory, every conv, transposed-conv and linear layer holds the
  lecun-normal draw of its flax fan-in (the layer cases hold that fan-in
  against JAX's) with the bias at zero or at its ``jax_bias``, every norm
  ones / zeros, every PReLU 0.25, every table ``normal(0.02)``, and no
  parameter is left outside these kinds. The zoo tests
  (``test_torch_port_zoo*.py``, ``..._nnunet.py``, ``..._natural*.py``)
  already hold each model's keys and shapes against flax's tree.

Per tensor, at one seed of each package: where JAX's draw is constant the
port's equals it exactly; otherwise the standard deviations of the two
lie within ``5 / sqrt(n)`` of each other (relative; two independent draws
of n values differ by about ``1 / sqrt(n)``), the port's mean within ``4 *
std / sqrt(n)`` of zero, and where JAX's draw is bounded by its truncation
(``max|w| <= 2 std / 0.8796``, up to the same sampling margin) so is the
port's.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
from flax import linen as fnn
from flax.core import scope as flax_scope

from arco_tpu.models import enet as jenet
from arco_tpu.models import heads as jheads
from arco_tpu.models import swin_unet as jswin
from arco_tpu.models import unet3d as junet3d
from arco_tpu.models.factory import net_factory as jax_net_factory
from arco_tpu.models.factory import net_factory_3d as jax_net_factory_3d

from arco_torch.compat.from_flax import (
    _dense, _mha, feature_extractor_state_dict_from_flax,
    head_state_dict_from_flax, model_state_dict_from_flax)
from arco_torch.models import swin_unet, transunet, unet3d
from arco_torch.models.factory import (natural_model, net_factory,
                                       net_factory_3d)
from arco_torch.models.init import TRUNC_STD, fan_in, jax_init_
from arco_torch.train.arco2d import make_arco_modules
from arco_torch.train.pretrain import make_isd_modules

torch.set_num_threads(4)

SEEDS = (0, 1, 2)
KERNELS = (tnn.Conv1d, tnn.Conv2d, tnn.Conv3d, tnn.ConvTranspose1d,
           tnn.ConvTranspose2d, tnn.ConvTranspose3d, tnn.Linear)
NORMS = (tnn.BatchNorm1d, tnn.BatchNorm2d, tnn.BatchNorm3d, tnn.LayerNorm,
         tnn.GroupNorm)
TABLES = ("relative_position_bias_table", "absolute_pos_embed",
          "pos_embedding")


# ---- JAX's draws

def jax_draws(module, *args, seed=0, **kwargs):
    """{collection: nested dict} of what ``module.init(..., *args)``
    creates, each leaf drawn by JAX's own initializer for it (see the
    module docstring)."""
    recs = {}
    param, variable = flax_scope.Scope.param, flax_scope.Scope.variable

    def rec_param(self, name, init_fn, *a, unbox=True, **k):
        path = ("params",) + tuple(self.path) + (name,)
        if path not in recs and not self.has_variable("params", name):
            recs[path] = (True, init_fn, a, k)
        return param(self, name, init_fn, *a, unbox=unbox, **k)

    def rec_variable(self, col, name, init_fn=None, *a, unbox=True, **k):
        path = (col,) + tuple(self.path) + (name,)
        if init_fn is not None and path not in recs \
                and not self.has_variable(col, name):
            recs[path] = (False, init_fn, a, k)
        return variable(self, col, name, init_fn, *a, unbox=unbox, **k)

    flax_scope.Scope.param = rec_param
    flax_scope.Scope.variable = rec_variable
    try:
        key = jax.random.PRNGKey(0)
        jax.eval_shape(lambda: module.init(
            {"params": key, "dropout": key}, *args, **kwargs))
    finally:
        flax_scope.Scope.param, flax_scope.Scope.variable = param, variable
    items = list(recs.items())

    @jax.jit
    def draw(key):
        return [fn(jax.random.fold_in(key, i), *a, **k) if rng else
                fn(*a, **k)
                for i, (_, (rng, fn, a, k)) in enumerate(items)]

    tree = {}
    for (path, _), value in zip(items, draw(jax.random.key(seed,
                                                           impl="rbg"))):
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.asarray(value)
    return tree


# ---- the per-tensor comparison

def _stats_match(name, got, want):
    """``got`` (the port's tensor) drawn as ``want`` (JAX's, numpy)."""
    got = got.detach().double().numpy()
    assert got.shape == want.shape, name
    if want.min() == want.max():
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    n = want.size
    s_got, s_want = got.std(), float(want.std())
    margin = 5 / math.sqrt(n)
    assert abs(s_got / s_want - 1) <= margin, (name, s_got, s_want)
    assert abs(got.mean()) <= 4 * s_got / math.sqrt(n), (name, got.mean())
    bound = 2 * s_want / TRUNC_STD * (1 + margin)
    if np.abs(want).max() <= bound:
        assert np.abs(got).max() <= bound, (name, np.abs(got).max(), bound)


def assert_drawn_as(port_sd, jax_sd):
    """The same keys and shapes, and each tensor drawn as JAX's."""
    port_sd = {k: v for k, v in port_sd.items()
               if not k.endswith("num_batches_tracked")}
    jax_sd = {k: v for k, v in jax_sd.items()
              if not k.endswith("num_batches_tracked")}
    assert sorted(port_sd) == sorted(jax_sd)
    for k, v in port_sd.items():
        _stats_match(k, v, np.asarray(jax_sd[k], np.float64))


def assert_lecun(name, w, fan):
    """``w`` holds flax's lecun-normal draw at fan-in ``fan``."""
    w = w.detach().double()
    n, std = w.numel(), 1 / math.sqrt(fan)
    assert abs(float(w.std()) / std - 1) <= 5 / math.sqrt(n), \
        (name, float(w.std()), std)
    assert abs(float(w.mean())) <= 4 * std / math.sqrt(n), name
    assert float(w.abs().max()) <= 2 * std / TRUNC_STD * (1 + 1e-6), name


# ---- whole models and heads against JAX

def _sd(tree):
    return tree["params"], tree.get("batch_stats", {})


def test_unet_of_the_2d_gate():
    jp, js = _sd(jax_draws(jax_net_factory("unet", in_chns=1, class_num=3),
                           jnp.zeros((1, 32, 32, 1)), train=True))
    torch.manual_seed(0)
    port = net_factory("unet", in_chns=1, class_num=3)
    assert_drawn_as(port.state_dict(), model_state_dict_from_flax(jp, js))


def test_unet_of_the_natural_gate():
    """3 input channels (natural_model's U-Net)."""
    jp, js = _sd(jax_draws(jax_net_factory("unet", in_chns=3, class_num=4),
                           jnp.zeros((1, 32, 32, 3)), train=True, seed=1))
    torch.manual_seed(1)
    port = natural_model("unet", num_classes=4)
    assert_drawn_as(port.state_dict(), model_state_dict_from_flax(jp, js))


def test_vnet_of_the_3d_gate():
    jp, js = _sd(jax_draws(jax_net_factory_3d("vnet", in_chns=1,
                                              class_num=3),
                           jnp.zeros((1, 16, 16, 16, 1)), train=True))
    torch.manual_seed(0)
    port = net_factory_3d("vnet", in_chns=1, class_num=3)
    assert_drawn_as(port.state_dict(), model_state_dict_from_flax(jp, js))


@pytest.mark.parametrize("nd", [2, 3])
def test_arco_heads(nd):
    """make_arco_modules' FeatureExtractor and QRepresentation: the 2D
    trainer's (U-Net maps fused to 496) and the 3D one's (V-Net maps fused
    to 16)."""
    fea, fused = ((256, 128, 64, 32, 16), 496) if nd == 2 \
        else ((128, 64, 32, 16, 16), 16)
    maps = [jnp.zeros((1,) + (2,) * nd + (c,)) for c in fea]
    jfe = jax_draws(jheads.FeatureExtractor(fea_dim=fea, output_dim=fused),
                    maps)["params"]
    jqr = jax_draws(jheads.QRepresentation(channels=fused),
                    jnp.zeros((1,) + (2,) * nd + (fused,)))["params"]
    torch.manual_seed(0)
    mods = make_arco_modules(types.SimpleNamespace(spatial_dims=nd), 8, 8,
                             batch_size=2, feature_channels=fea,
                             fused_dim=fused)
    assert_drawn_as(mods.feature_extractor.state_dict(),
                    feature_extractor_state_dict_from_flax(jfe))
    assert_drawn_as(mods.q_representation.state_dict(),
                    head_state_dict_from_flax(jqr))


@pytest.mark.parametrize("nd", [2, 3])
def test_isd_heads(nd):
    """make_isd_modules' four heads at make_isd_modules' defaults (latent
    512, the outputs pooled to 8), 4 classes, the U-Net's 256-channel
    latent in 2D and the V-Net's 128 in 3D."""
    latent = 256 if nd == 2 else 128
    sp = (1,) + (8,) * nd
    want = {
        "latent_head": jheads.LatentMLP(input_channels=256, num_class=512),
        "latent_predictor": jheads.LatentPredictor(feature_size=512),
        "outputs_head": jheads.ProjectionHead(proj_dim=4,
                                              output_pooling_size=8),
        "outputs_predictor": jheads.OutputsPredictor(num_classes=4)}
    inputs = {"latent_head": jnp.zeros(sp + (latent,)),
              "latent_predictor": jnp.zeros((1, 512)),
              "outputs_head": jnp.zeros(sp + (4,)),
              "outputs_predictor": jnp.zeros(sp + (4,))}
    torch.manual_seed(0)
    mods = make_isd_modules(types.SimpleNamespace(
        spatial_dims=nd, latent_channels=latent), 4)
    for name, module in want.items():
        jp = jax_draws(module, inputs[name])["params"]
        assert_drawn_as(getattr(mods, name).state_dict(),
                        head_state_dict_from_flax(jp))


# ---- layer kinds against JAX, fan-in checked directly

def _conv_sd(p):
    k = p["kernel"]
    nd = k.ndim - 2
    sd = {"weight": torch.from_numpy(np.ascontiguousarray(
        k.transpose((nd + 1, nd) + tuple(range(nd)))))}
    if "bias" in p:
        sd["bias"] = torch.from_numpy(p["bias"])
    return sd


def _convt_sd(p):
    """flax's [*k, in, out] transposed-conv kernel as torch's [in, out,
    *k] (no flip: a draw's distribution does not see it)."""
    k = p["kernel"]
    nd = k.ndim - 2
    sd = {"weight": torch.from_numpy(np.ascontiguousarray(
        k.transpose((nd, nd + 1) + tuple(range(nd)))))}
    if "bias" in p:
        sd["bias"] = torch.from_numpy(p["bias"])
    return sd


# (JAX module, its input, the port's layer, the flax fan-in, the tree ->
# the port's keys)
LAYERS = {
    "conv2d": (lambda: fnn.Conv(48, (3, 3)), (1, 6, 6, 32),
               lambda: tnn.Conv2d(32, 48, 3, padding=1), 9 * 32, _conv_sd),
    "conv3d": (lambda: fnn.Conv(24, (3, 3, 3)), (1, 4, 4, 4, 16),
               lambda: tnn.Conv3d(16, 24, 3, padding=1), 27 * 16, _conv_sd),
    "grouped_conv": (lambda: fnn.Conv(64, (3, 3), feature_group_count=8),
                     (1, 6, 6, 64),
                     lambda: tnn.Conv2d(64, 64, 3, padding=1, groups=8),
                     9 * 8, _conv_sd),
    "depthwise_conv": (lambda: fnn.Conv(96, (3, 3), feature_group_count=96,
                                        use_bias=False), (1, 6, 6, 96),
                       lambda: tnn.Conv2d(96, 96, 3, padding=1, groups=96,
                                          bias=False), 9, _conv_sd),
    "conv_transpose2d": (lambda: fnn.ConvTranspose(32, (2, 2), strides=(2, 2)),
                         (1, 4, 4, 64),
                         lambda: tnn.ConvTranspose2d(64, 32, 2, stride=2),
                         4 * 64, _convt_sd),
    "conv_transpose3d": (lambda: fnn.ConvTranspose(16, (2, 2, 2),
                                                   strides=(2, 2, 2)),
                         (1, 2, 2, 2, 32),
                         lambda: tnn.ConvTranspose3d(32, 16, 2, stride=2),
                         8 * 32, _convt_sd),
    "dense": (lambda: fnn.Dense(200), (1, 300),
              lambda: tnn.Linear(300, 200), 300, _dense),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_draws_as_flax(kind, seed):
    make_jax, shape, make_port, fan, to_port = LAYERS[kind]
    jp = jax_draws(make_jax(), jnp.zeros(shape), seed=seed)["params"]
    torch.manual_seed(seed)
    layer = jax_init_(make_port())
    assert fan_in(layer) == fan
    assert_drawn_as(layer.state_dict(), to_port(jp))
    assert_lecun(kind, layer.weight, fan)
    assert_lecun(f"jax {kind}", torch.from_numpy(jp["kernel"]), fan)


def test_explicit_generator():
    """With a generator the draw is that generator's alone: the same seed
    gives the same weights, and torch's global generator is not read."""
    def draw(seed):
        layer = tnn.Conv2d(32, 48, 3)
        torch.manual_seed(123)
        jax_init_(layer, torch.Generator().manual_seed(seed))
        return layer.weight.detach().clone(), torch.rand(1)
    (w0, r0), (w1, r1), (w2, _) = draw(0), draw(0), draw(1)
    assert torch.equal(w0, w1) and not torch.equal(w0, w2)
    torch.manual_seed(123)
    assert torch.equal(r0, torch.rand(1)) and torch.equal(r0, r1)
    assert_lecun("conv2d", w0, 9 * 32)


@pytest.mark.parametrize("seed", SEEDS)
def test_attention_projections(seed):
    """ViT_Seg's attention (flax's MultiHeadDotProductAttention with
    qkv_features = hidden): query / key / value take fan-in hidden, the
    output heads x head_dim; the port's four Linear layers their
    in_features."""
    hidden, heads = 96, 4
    jp = jax_draws(fnn.MultiHeadDotProductAttention(
        num_heads=heads, qkv_features=hidden, deterministic=True),
        jnp.zeros((1, 5, hidden)), seed=seed)["params"]
    torch.manual_seed(seed)
    att = jax_init_(transunet.Attention(hidden, heads))
    assert_drawn_as(att.state_dict(), _mha(jp))
    for name in ("query", "key", "value", "out"):
        layer = getattr(att, name)
        assert fan_in(layer) == hidden
        assert_lecun(name, layer.weight, hidden)
        # flax's DenseGeneral draws over its flattened [in, out] kernel
        k = jp[name]["kernel"]
        k = k.reshape(-1, k.shape[-1]) if name == "out" \
            else k.reshape(k.shape[0], -1)
        assert_lecun(f"jax {name}", torch.from_numpy(k), hidden)


@pytest.mark.parametrize("seed", SEEDS)
def test_swin_window_attention(seed):
    """qkv and proj Dense layers, and the relative-position bias table at
    normal(0.02)."""
    dim, heads, ws = 64, 4, 4
    jp = jax_draws(jswin.WindowAttention(dim=dim, num_heads=heads,
                                         window_size=ws),
                   jnp.zeros((1, ws * ws, dim)), seed=seed)["params"]
    torch.manual_seed(seed)
    att = jax_init_(swin_unet.WindowAttention(dim, heads, ws))
    want = {"relative_position_bias_table": torch.from_numpy(
        jp["relative_position_bias_table"])}
    for name, port_name in (("Dense_0", "qkv"), ("Dense_1", "proj")):
        want.update({f"{port_name}.{k}": v
                     for k, v in _dense(jp[name]).items()})
    assert_drawn_as(att.state_dict(), want)
    table = att.relative_position_bias_table.detach().double()
    assert abs(float(table.std()) / 0.02 - 1) <= 5 / math.sqrt(table.numel())


def test_prelu_slope():
    jp = jax_draws(jenet.PReLU(), jnp.zeros((1, 4)))["params"]
    torch.manual_seed(0)
    port = net_factory("enet", in_chns=1, class_num=4)
    slopes = [m.weight for m in port.modules() if isinstance(m, tnn.PReLU)]
    assert slopes
    for w in slopes:
        assert torch.equal(w.detach(), torch.from_numpy(jp["alpha"]))


@pytest.mark.parametrize("mode,bias", [("concatenation_sigmoid", 3.0),
                                       ("concatenation_softmax", 10.0),
                                       ("concatenation_mean", 0.0)])
def test_attention_gate_psi_bias(mode, bias):
    """The TORR gate's psi bias keeps JAX's bias_init through jax_init_;
    its kernels draw lecun-normal."""
    x, g = jnp.zeros((1, 4, 4, 4, 16)), jnp.zeros((1, 4, 4, 4, 32))
    jp = jax_draws(junet3d.GridAttentionBlockTORR(inter_channels=8,
                                                  mode=mode),
                   x, g, train=True)["params"]
    psi = [p["bias"] for p in jp.values()
           if "kernel" in p and p["kernel"].shape[-1] == 1]
    assert len(psi) == 1 and np.all(psi[0] == bias)
    torch.manual_seed(0)
    gate = jax_init_(unet3d.GridAttentionBlockTORR(16, 32, 8, mode=mode,
                                                   nd=3))
    assert torch.equal(gate.psi.bias.detach(),
                       torch.full((1,), bias, dtype=torch.float32))
    assert_lecun("psi", gate.psi.weight, 8)
    assert_lecun("phi", gate.phi.weight, 32)


# ---- the rest of the zoo, port only

def _builds():
    out = {f"2d/{k}": (lambda k=k: net_factory(k, in_chns=1, class_num=4,
                                               img_size=64))
           for k in ("unet_ds", "unet_cct", "unet_urpc", "unet_har",
                     "unet_stego", "enet", "pnet", "efficient_unet",
                     "ViT_Seg", "swin_unet", "nnUNet")}
    out.update({f"3d/{k}": (lambda k=k: net_factory_3d(k, in_chns=1,
                                                       class_num=2))
                for k in ("unet_3D", "unet_3D_dv_semi", "attention_unet",
                          "voxresnet", "nnUNet")})
    out.update({f"natural/{k}": (lambda k=k: natural_model(k, "resnet50", 4))
                for k in ("deeplabv2", "deeplabv3")})
    return out


BUILDS = _builds()


@pytest.mark.parametrize("key", sorted(BUILDS))
def test_factory_draws_every_layer_as_flax(key):
    torch.manual_seed(0)
    model = BUILDS[key]()
    seen = set()
    for mname, m in model.named_modules():
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, KERNELS):
            assert_lecun(f"{mname}.weight", m.weight, fan_in(m))
            if m.bias is not None:
                want = getattr(m, "jax_bias", 0.0)
                assert torch.all(m.bias == want), f"{mname}.bias"
        elif isinstance(m, NORMS) or type(m).__name__ in (
                "BatchNormMul", "InstanceNormAffine", "BatchNorm2d",
                "BatchNorm3d"):
            for name, p in own.items():
                want = 1.0 if name in ("weight", "gamma") else 0.0
                assert torch.all(p == want), f"{mname}.{name}"
        elif isinstance(m, tnn.PReLU):
            assert torch.all(m.weight == 0.25), mname
        else:
            for name, p in own.items():
                assert name in TABLES, f"{key}: {mname}.{name}"
                std = float(p.detach().double().std())
                assert abs(std / 0.02 - 1) <= 5 / math.sqrt(p.numel()), \
                    (mname, name, std)
        seen.update(id(p) for p in own.values())
    assert seen == {id(p) for p in model.parameters()}
