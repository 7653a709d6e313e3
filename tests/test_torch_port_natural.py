"""The natural-image branch's models and library functions of the PyTorch
port against the JAX package (CPU, TF32 off): DeepLabV2, DeepLabV3Plus and
DeepLab2Branch, ``max_pool_ceil``, ``model_generator``, the
``--restore_from`` partial copy and ``apply_deeplab_bn_freeze`` (the data
functions are in test_torch_port_natural_data.py).

Each model gets seeded random weights of flax's shapes (``jax.eval_shape``,
nothing compiled for the init; test_torch_port_zoo2d.py:random_variables)
carried across by compat/from_flax.py, at small depth (one block a layer)
at 65x65 and 64x64 (the ceil-mode max pool's two cases), plus DeepLab-v2
at ResNet-50 depth, batch 2. JAX runs in float64 (``jax.enable_x64``, the
modules' dtype float64): the port's float64 eval and train forwards lie
within 1e-5 of the outputs' scale of JAX's (not closer: both frameworks
resize in float32, and flax's eval-mode BatchNorm takes the rsqrt of its
float32 running variance), its running statistics after one train
forward within 1e-7, and the gradients of a loss of the train forward's
outputs as stated at GRAD_F64_TOL. The port's float32 forwards are held to
its float64 ones at 1e-4 of the scale (room for the ResNet-50 case's 16
BatchNorms in train mode), its gradients at GRAD_F32_TOL.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arco_tpu.compat.torch_import import (convert_deeplab_state_dict,
                                          merge_params)
from arco_tpu.models import deeplab as jdl
from arco_tpu.train.freeze import \
    apply_deeplab_bn_freeze as jax_apply_deeplab_bn_freeze
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.compat import from_flax
from arco_torch.compat.torch_import import load_partial_state_dict
from arco_torch.models import deeplab as tdl
from arco_torch.models.factory import check_natural_model, natural_model
from arco_torch.train.freeze import apply_deeplab_bn_freeze
from arco_torch.train.schedule import make_optimizer, poly_lr, set_lr

from test_torch_port_zoo2d import _close, nchw, random_variables, to_nhwc

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

F64_TOL = dict(rtol=0.0, atol=1e-5)         # of the outputs' scale
STATS_F64_TOL = dict(rtol=0.0, atol=1e-7)
F32_TOL = dict(rtol=0.0, atol=1e-4)          # port f32 against port f64
# gradients of the train forward's mean-square loss, of the largest one:
# float64 against JAX's float64 within 1e-5 (a cross-entropy gradient
# lies 4.1e-7 away, from the float32 resizes); float32 against the port's own float64 within 5e-2: the
# ReLUs right after train-mode BatchNorms of 9x9 maps amplify f32 rounding
# (a cross-entropy gradient of DeepLab-v2 at this depth lies 2.19e-2 of
# the largest from float64 in the port and 3.88e-2 in JAX's own float32;
# scripts/torch_deeplab_rounding.py)
GRAD_F64_TOL = dict(rtol=0.0, atol=1e-5)
GRAD_F32_TOL = dict(rtol=0.0, atol=5e-2)
SMALL = (1, 1, 1, 1)
NC = 4

KINDS = {"v2": (jdl.DeepLabV2, tdl.DeepLabV2),
         "v3": (jdl.DeepLabV3Plus, tdl.DeepLabV3Plus),
         "2branch": (jdl.DeepLab2Branch, tdl.DeepLab2Branch)}
# DeepLab-v2 here; v3+ (at batch 1 too: the ASPP's pooled BatchNorm then
# sees one value a channel) and 2branch in test_torch_port_natural_v3.py,
# so that pytest-xdist runs the two halves side by side
CASES = [("v2", 65, SMALL, 2), ("v2", 64, SMALL, 2),
         ("v2", 65, (3, 4, 6, 3), 2)]
CASES_V3 = [(k, hw, SMALL, 2) for k in ("v3", "2branch") for hw in (65, 64)] \
    + [("v3", 65, SMALL, 1)]


def case_id(case):
    k, hw, ly, b = case
    return f"{k}-{hw}-{'x'.join(map(str, ly))}-bs{b}"


def _flat(out):
    flat = []
    for o in out:
        if isinstance(o, (list, tuple)):
            flat += _flat(o)
        elif o is not None:
            flat.append(o)
    return flat


def _jax_layout(t):
    return to_nhwc(t) if t.ndim == 4 else t.detach().double().numpy()


def _port_sd(params, stats, dtype):
    sd = from_flax.model_state_dict_from_flax(params, stats)
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in sd.items()}


class DeepLabPair:
    """One model in both frameworks with the same weights: JAX's float64
    eval and train forwards (and the statistics the train forward left),
    the port's float64 and float32 ones."""

    def __init__(self, kind, hw, layers, batch):
        jcls, tcls = KINDS[kind]
        x = np.random.RandomState(1).randn(batch, hw, hw, 3) \
            .astype(np.float32)
        with jax.enable_x64(True):
            jm = jcls(num_classes=NC, layers=layers, dtype=jnp.float64)
            jx = jnp.asarray(x, jnp.float64)
            self.params, self.stats = random_variables(jm, jx)
            v = {"params": self.params, "batch_stats": self.stats}

            def train_loss(params):
                out, mut = jm.apply({"params": params,
                                     "batch_stats": self.stats}, jx,
                                    train=True, mutable=["batch_stats"])
                return sum(jnp.mean(jnp.square(o))
                           for o in _flat(out)), (out, mut)

            run = jax.jit(lambda v: (
                jm.apply(v, jx, train=False),
                jax.grad(train_loss, has_aux=True)(v["params"])))
            eval_out, (grads, (train_out, mut)) = run(v)
            self.jax_eval = [np.asarray(o) for o in _flat(eval_out)]
            self.jax_train = [np.asarray(o) for o in _flat(train_out)]
            self.jax_stats = jax.tree_util.tree_map(np.asarray,
                                                    mut["batch_stats"])
            self.jax_grads = from_flax.model_state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, grads), self.stats)
        self.port = {}
        for dt in (torch.float64, torch.float32):
            model = tcls(num_classes=NC, layers=layers).to(dt)
            model.load_state_dict(_port_sd(self.params, self.stats, dt))
            xt = nchw(x).to(dt)
            with torch.no_grad():
                ev = _flat(model.eval()(xt))
            tr = _flat(model.train()(xt))
            sum(torch.mean(torch.square(o)) for o in tr).backward()
            self.port[dt] = ([_jax_layout(o) for o in ev],
                             [_jax_layout(o) for o in tr],
                             model.state_dict(),
                             {k: p.grad.double().numpy()
                              for k, p in model.named_parameters()})


@pytest.fixture(scope="module", params=CASES, ids=case_id)
def pair(request):
    return DeepLabPair(*request.param)


def test_eval_forward_float64(pair):
    got = pair.port[torch.float64][0]
    assert len(got) == len(pair.jax_eval)
    for i, (g, w) in enumerate(zip(got, pair.jax_eval)):
        _close(g, w, what=f"eval output {i}", **F64_TOL)


def test_train_forward_float64(pair):
    got = pair.port[torch.float64][1]
    for i, (g, w) in enumerate(zip(got, pair.jax_train)):
        _close(g, w, what=f"train output {i}", **F64_TOL)


def test_running_stats_after_train_forward(pair):
    want = from_flax.model_state_dict_from_flax(pair.params, pair.jax_stats)
    got = pair.port[torch.float64][2]
    names = [k for k in want if "running" in k]
    assert names
    for k in names:
        _close(got[k].numpy(), want[k].numpy(), what=k, **STATS_F64_TOL)


def test_float32_against_float64(pair):
    (e64, t64, _, _), (e32, t32, _, _) = (pair.port[torch.float64],
                                          pair.port[torch.float32])
    for i, (g, w) in enumerate(zip(e32 + t32, e64 + t64)):
        _close(g, w, what=f"output {i}", **F32_TOL)


def test_gradients_float64(pair):
    got = pair.port[torch.float64][3]
    scale = max(np.abs(g.numpy()).max() for g in pair.jax_grads.values()
                if g.is_floating_point())
    for k, g in got.items():
        _close(g, pair.jax_grads[k].numpy(), what=k, scale=scale,
               **GRAD_F64_TOL)


def test_gradients_float32_against_float64(pair):
    g64, g32 = pair.port[torch.float64][3], pair.port[torch.float32][3]
    scale = max(np.abs(g).max() for g in g64.values())
    for k, g in g32.items():
        _close(g, g64[k], what=k, scale=scale, **GRAD_F32_TOL)


def test_fine_to_coarse_maps():
    """The four stage maps come fine -> coarse: 81 -> 41 at Pascal's 321
    for v2 (output stride 8), 81 -> 21 for v3+ (16); the fused rep is
    layer4's size."""
    for cls, sizes in ((tdl.DeepLabV2, (81, 41, 41, 41)),
                       (tdl.DeepLabV3Plus, (81, 41, 21, 21))):
        model = cls(num_classes=NC, layers=SMALL).eval()
        with torch.no_grad():
            logits, _, feats = model(torch.zeros(1, 3, 321, 321))
        assert tuple(logits.shape) == (1, NC, 321, 321)
        assert [f.shape[-1] for f in feats] == list(sizes)
        assert [f.shape[1] for f in feats] == \
            list(tdl.deeplab_feature_channels("deeplabv2"))


@pytest.mark.parametrize("hw", [64, 65, 321, 7])
def test_max_pool_ceil(hw):
    x = np.random.RandomState(0).randn(2, hw, hw, 8).astype(np.float32)
    want = np.asarray(jdl.max_pool_ceil(jnp.asarray(x)))
    got = to_nhwc(tdl.max_pool_ceil(nchw(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key,backbone", [
    ("deeplabv2", "resnet101"), ("deeplabv2", "resnet50"),
    ("deeplabv3", "resnet101"), ("deeplabv3", "resnet50"),
    ("DeepLab", "resnet101"), ("DeepLab_2branch", "resnet101"),
    ("DeepLab50_2branch", "resnet101"), ("deeplab_2branch", "resnet50")])
def test_model_generator_dispatch(key, backbone):
    jm = jdl.model_generator(key, backbone, num_classes=NC)
    tm = tdl.model_generator(key, backbone, num_classes=NC)
    assert type(tm).__name__ == type(jm).__name__
    n_blocks = [len(getattr(tm, f"layer{i}")) for i in range(1, 5)]
    assert tuple(n_blocks) == tuple(jm.layers)
    assert tm.num_classes == NC


def test_factory_and_key_table():
    assert isinstance(natural_model("deeplabv2", "resnet50", 21),
                      tdl.DeepLabV2)
    assert isinstance(natural_model("deeplabv3", "resnet50", 19),
                      tdl.DeepLabV3Plus)
    unet = natural_model("unet", num_classes=21)
    assert unet.encoder.in_conv.conv_conv[0].in_channels == 3
    check_natural_model("unet", (320, 320), "train_arco_natural")
    check_natural_model("deeplabv2", (321, 321), "train_arco_natural")
    check_natural_model("deeplab", (321, 321), "eval_natural")
    check_natural_model("unet_stego", (64, 64), "eval_natural")
    with pytest.raises(ValueError, match="divisible by 16"):
        check_natural_model("unet", (321, 321), "train_arco_natural")
    with pytest.raises(ValueError, match="four values"):
        check_natural_model("deeplab_2branch", (321, 321), "eval_natural")
    with pytest.raises(ValueError, match="not one of"):
        check_natural_model("unet_stego", (64, 64), "train_arco_natural")
    with pytest.raises(ValueError, match="four values"):
        check_natural_model("unet_ds", (64, 64), "eval_natural")


# ----------------------------------------------------------- restore/freeze

def _synthetic_reference_sd(layers, num_classes):
    """A reference-style DeepLab-v2 checkpoint (DataParallel 'module.'
    names) of seeded weights, of another class count than the model."""
    torch.manual_seed(5)
    src = tdl.DeepLabV2(num_classes=num_classes, layers=layers)
    with torch.no_grad():
        for v in src.state_dict().values():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape) * 0.1 + 0.5)
    return {f"module.{k}": v.clone() for k, v in src.state_dict().items()}


@pytest.mark.parametrize("kind,classes", [("v2", 7), ("v2", NC),
                                          ("v3", 7)])
def test_restore_matches_convert_and_merge(kind, classes):
    """load_partial_state_dict against JAX's convert_deeplab_state_dict +
    merge_params on one synthetic checkpoint: the trunk comes from the
    file, a classifier of another class count (or v3+'s heads) keeps the
    init."""
    jcls, tcls = KINDS[kind]
    x = jnp.zeros((1, 33, 33, 3))
    init_p, init_s = random_variables(jcls(num_classes=NC, layers=SMALL), x)
    sd = _synthetic_reference_sd(SMALL, classes)
    imp_p, imp_s = convert_deeplab_state_dict(
        {k.replace("module.", ""): v for k, v in sd.items()}, SMALL)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    want = from_flax.model_state_dict_from_flax(
        to_np(merge_params(init_p, imp_p)),
        to_np(merge_params(init_s, imp_s)))
    model = tcls(num_classes=NC, layers=SMALL)
    model.load_state_dict(_port_sd(init_p, init_s, torch.float32))
    copied = load_partial_state_dict(model, sd)
    got = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
    assert "conv1.weight" in copied and "layer4.0.bn3.running_var" in copied
    assert ("layer5.conv2d_list.0.weight" in copied) == \
        (kind == "v2" and classes == NC)


def test_bn_freeze_one_sgd_step():
    """apply_deeplab_bn_freeze against JAX's optax.multi_transform: after
    two SGD steps on the same gradients the BatchNorm scales and biases
    are bit-identical to the start (no momentum, no weight decay) and
    every other weight equals JAX's within 1e-6."""
    x = jnp.zeros((1, 33, 33, 3))
    params, stats = random_variables(jdl.DeepLabV2(num_classes=NC,
                                                   layers=SMALL), x)
    rs = np.random.RandomState(3)
    grads = [jax.tree_util.tree_map(
        lambda p: rs.randn(*p.shape).astype(np.float32), params)
        for _ in range(2)]
    tx = jax_make_optimizer(0.01, 100)
    tx = jax_apply_deeplab_bn_freeze(tx, {"model": params})
    opt = tx.init({"model": params})
    jp = {"model": params}

    @jax.jit
    def update(g, opt, jp):
        upd, opt = tx.update({"model": g}, opt, jp)
        return optax.apply_updates(jp, upd), opt
    for g in grads:
        jp, opt = update(g, opt, jp)
    want = from_flax.model_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jp["model"]), stats)

    model = tdl.DeepLabV2(num_classes=NC, layers=SMALL)
    model.load_state_dict(_port_sd(params, stats, torch.float32))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainable = apply_deeplab_bn_freeze(model)
    n_bn = sum(1 for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    assert len(list(model.parameters())) - len(trainable) == 2 * n_bn
    opt_t = make_optimizer(trainable, 0.01)
    named = dict(model.named_parameters())
    for step, g in enumerate(grads):
        gsd = from_flax.model_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, g), stats)
        for name, p in named.items():
            p.grad = gsd[name].clone() if p.requires_grad else None
        set_lr(opt_t, poly_lr(0.01, step, 100))
        opt_t.step()
    got = model.state_dict()
    for name in named:
        if named[name].requires_grad:
            np.testing.assert_allclose(got[name].numpy(),
                                       want[name].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        else:
            assert torch.equal(got[name], start[name]), name
            np.testing.assert_array_equal(got[name].numpy(),
                                          want[name].numpy())
