"""The port's plain supervised trainer (arco_torch/train/supervised.py)
against JAX's (arco_tpu/train/supervised.py).

One and two steps of the U-Net at 16x16, bs 8, 2 classes: JAX's
``make_supervised_step`` from seeded weights of flax's shapes and the
port's from the same weights carried across (compat/from_flax.py), on the
same batch and JAX's dropout keep-masks (read with
``flax.linen.intercept_methods`` for the key each JAX step draws). Both
run the network in the parameters' dtype and the losses in f32.

Tolerances, measured on this host (max over both steps): in f32 the loss
terms agree within 4.0e-7 relative and the weights and BatchNorm
statistics within 4.8e-7, held at rtol 1e-5 and atol 5e-6; with the
network in float64 in both (JAX's U-Net built with ``dtype=float64`` under
``enable_x64``, where the dropout draws are f64 uniforms, so the masks are
read there too) the weights agree within 1.1e-8, held at atol 1e-7, and
the loss terms (f32 in both) within 3.4e-7, held at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from arco_tpu.models import net_factory as jax_net_factory
from arco_tpu.models.unet2d import UNet as JaxUNet
from arco_tpu.train import supervised as jsup
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.compat.from_flax import unet_state_dict_from_flax
from arco_torch.data.datasets import SliceDataset
from arco_torch.data.synthetic import make_acdc_like
from arco_torch.eval.slice2d import evaluate_2d
from arco_torch.models import net_factory
from arco_torch.train.supervised import (PolySGD, init_supervised_state,
                                         make_predict_fn,
                                         make_supervised_step)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

B, HW, NC, LR, ITERS = 8, 16, 2, 0.01, 10
TOL = {torch.float32: dict(loss=dict(rtol=1e-5, atol=0),
                           state=dict(rtol=0, atol=5e-6)),
       torch.float64: dict(loss=dict(rtol=1e-5, atol=0),
                           state=dict(rtol=0, atol=1e-7))}


def _batch(seed):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, NC, size=(B, HW, HW)).astype(np.int32)
    image = label[..., None].astype(np.float32) / (NC - 1) \
        + 0.1 * rs.randn(B, HW, HW, 1).astype(np.float32)
    return image, label


def jax_dropout_masks(jmodel, variables, x_shape, key):
    """The keep-masks that a train-mode forward of the flax U-Net draws
    with dropout key ``key`` (one per encoder block), as NCHW bool
    tensors: each Dropout with a nonzero rate is intercepted while the
    forward is traced, run once on ones and replayed on its input (under
    jit: eagerly, flax compiles each op apart, ~9 s a forward)."""
    def run(variables, key):
        masks = []

        def capture(next_fun, args, kwargs, context):
            mod = context.module
            if isinstance(mod, fnn.Dropout) and context.method_name == \
                    "__call__" and not mod.deterministic and mod.rate > 0:
                x = args[0]
                keep = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
                masks.append(keep)
                return jnp.where(keep, x / (1.0 - mod.rate),
                                 0).astype(x.dtype)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(capture):
            jmodel.apply(variables, jnp.zeros(x_shape), train=True,
                         rngs={"dropout": key}, mutable=["batch_stats"])
        return masks

    masks = jax.jit(run)(variables, key)
    assert len(masks) == 5
    return [torch.from_numpy(np.moveaxis(np.asarray(m), -1, 1).copy())
            for m in masks]


def seeded_variables(jmodel, x_shape, seed=0):
    """Seeded numpy weights of the shapes flax's init makes (read with
    ``jax.eval_shape``: an eager flax init of the U-Net takes ~20 s on the
    CPU): kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), BatchNorm scales
    ~ 1 + N(0, 0.1^2), running means ~ N(0, 0.1^2), variances ~ 1 +
    |N(0, 0.1^2)|."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros(x_shape), train=True))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = str(getattr(path[-1], "key", path[-1])), leaf.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "var":
            v = 1.0 + np.abs(0.1 * rs.randn(*shape))
        else:                              # bias, mean
            v = 0.1 * rs.randn(*shape)
        return np.asarray(v, np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return v["params"], v["batch_stats"]


def _np(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _run(dtype, n_steps=2):
    """n_steps of both steps from one state; per step the metrics of both
    and the state dicts after it (JAX's carried across)."""
    jmodel = jax_net_factory("unet", in_chns=1, class_num=NC)
    tx = jax_make_optimizer(LR, ITERS)
    x64 = dtype == torch.float64
    np_dtype = np.float64 if x64 else np.float32
    params, stats = _np(seeded_variables(jmodel, (B, HW, HW, 1)), np_dtype)
    rng0 = jax.random.PRNGKey(0)
    if x64:
        jmodel = JaxUNet(in_chns=1, class_num=NC, dtype=jnp.float64)

    model = net_factory("unet", in_chns=1, class_num=NC)
    model.load_state_dict(unet_state_dict_from_flax(params, stats))
    model = model.to(dtype)
    tx_port = PolySGD(LR, ITERS)
    port_state = init_supervised_state(model, tx_port, device="cpu")
    port_step = make_supervised_step(model, tx_port, NC)

    image, label = _batch(0)
    out = []
    with jax.enable_x64(x64):
        # under x64 the dropout draws are f64 uniforms: other masks
        masks = []
        rng = rng0
        for _ in range(n_steps):
            rng, k = jax.random.split(rng)
            masks.append(jax_dropout_masks(
                jmodel, {"params": params, "batch_stats": stats},
                (B, HW, HW, 1), k))
        jstate = jsup.SupervisedState(params=params, batch_stats=stats,
                                      opt_state=tx.init(params),
                                      rng=rng0, step=jnp.array(0, jnp.int32))
        jstep = jsup.make_supervised_step(jmodel, tx, NC)
        jbatch = {"image": jnp.asarray(image.astype(np_dtype)),
                  "label": jnp.asarray(label)}
        tbatch = {"image": torch.from_numpy(np.moveaxis(image, -1, 1)
                                            .copy()).to(dtype),
                  "label": torch.from_numpy(label)}
        for i in range(n_steps):
            jstate, jm = jstep(jstate, jbatch)
            port_state, pm = port_step(port_state, tbatch, masks[i])
            want_sd = unet_state_dict_from_flax(
                _np(jstate.params, np_dtype), _np(jstate.batch_stats,
                                                  np_dtype))
            out.append({"jax": {k: float(v) for k, v in jm.items()},
                        "port": {k: float(v) for k, v in pm.items()},
                        "want_sd": want_sd,
                        "got_sd": {k: v.clone()
                                   for k, v in model.state_dict().items()}})
    return out


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def steps(request):
    return request.param, _run(request.param)


@pytest.mark.parametrize("n", [1, 2])
def test_step_metrics_match_jax(steps, n):
    dtype, out = steps
    rec = out[n - 1]
    for k in ("loss", "loss_ce", "loss_dice"):
        np.testing.assert_allclose(rec["port"][k], rec["jax"][k],
                                   err_msg=k, **TOL[dtype]["loss"])


@pytest.mark.parametrize("n", [1, 2])
def test_step_weights_match_jax(steps, n):
    """Every parameter and BatchNorm statistic after n steps."""
    dtype, out = steps
    rec = out[n - 1]
    assert sorted(rec["got_sd"]) == sorted(rec["want_sd"])
    for k, want in rec["want_sd"].items():
        got = rec["got_sd"][k]
        if not got.is_floating_point():
            continue
        np.testing.assert_allclose(got.double().numpy(),
                                   want.double().numpy(), err_msg=k,
                                   **TOL[dtype]["state"])


@pytest.mark.parametrize("output", ["argmax", "softmax"])
def test_predict_fn_matches_jax(output):
    """Eval-mode prediction from carried weights: labels equal, softmax
    within 1e-5."""
    jmodel = jax_net_factory("unet", in_chns=1, class_num=NC)
    params, stats = seeded_variables(jmodel, (2, 32, 32, 1), seed=1)
    x = np.random.RandomState(3).randn(2, 32, 32, 1).astype(np.float32)
    want = np.asarray(jsup.make_predict_fn(jmodel, output)(
        (params, stats), jnp.asarray(x)))
    model = net_factory("unet", in_chns=1, class_num=NC)
    model.load_state_dict(unet_state_dict_from_flax(params, stats))
    got = make_predict_fn(model, output)(
        torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    if output == "argmax":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.movedim(1, -1).numpy(), want,
                                   atol=1e-5)
    assert not model.training


def test_train_improves_dice(tmp_path):
    """The counterpart of tests/test_e2e_smoke.py: 60 supervised steps on a
    synthetic ACDC-shaped set lower the loss and raise the volume Dice."""
    num_classes = 3
    root = make_acdc_like(str(tmp_path / "acdc"), n_train=16, n_val=1,
                          size=(32, 32), num_classes=num_classes)
    torch.manual_seed(0)
    model = net_factory("unet", in_chns=1, class_num=num_classes)
    tx = PolySGD(0.05, 60)
    state = init_supervised_state(model, tx, device="cpu")
    step = make_supervised_step(model, tx, num_classes)
    ds = SliceDataset(root, "train", output_size=(32, 32), transform=False)
    val = SliceDataset(root, "val", list_name="val.list")
    host_rng = np.random.RandomState(0)
    predict = make_predict_fn(model)

    def run_eval():
        def pf(x):
            return predict(torch.from_numpy(x)).numpy()
        res = evaluate_2d(val.sample_list,
                          lambda c: val.load(val.sample_list.index(c)),
                          pf, num_classes, input_size=(32, 32))
        return float(res["mean"][0])

    dice_before = run_eval()
    losses = []
    for _ in range(60):
        idx = host_rng.randint(0, len(ds), size=8)
        samples = [ds.get(i, host_rng) for i in idx]
        batch = {"image": np.stack([s["image"] for s in samples])
                 .transpose(0, 3, 1, 2),
                 "label": np.stack([s["label"] for s in samples])}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    dice_after = run_eval()

    assert state.step == 60
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    assert dice_after > dice_before
    assert dice_after > 0.35, dice_after
