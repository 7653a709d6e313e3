"""The 3D stage 1 (ISD pretraining of the V-Net) of the PyTorch port against
the JAX package (CPU, f32, TF32 off).

- ``extract_patches_3d`` and the 3-D ``pooled_patch_grid`` at a grid that
  divides and one that does not: values and gradients, atol 1e-6 (both
  sides sum the same f32 values in another order); the 3-D
  ``adaptive_avg_pool`` likewise.
- The 3-D ISD heads with the flax weights carried across (1x1x1 kernels),
  atol 1e-5, among them ``LatentMLP`` on the V-Net's 128-channel latent
  with a 256-wide hidden layer, as arco_tpu/cli/pretrain_3d.py builds it.
- The V-Net's freeze labels: every parameter of the port's V-Net gets the
  label JAX's ``model_param_labels`` gives its flax counterpart; the 3-D
  U-Nets raise in both.
- Two pretrain steps of the V-Net at 32x32x16 (bs 2, 1 labeled, dropout
  on, K=6, latent 32, patch 16 pooled to 4^3: P = 9 patches of F = 128),
  each from the JAX ``PretrainState`` before it (ROADMAP Queue C,
  "Pretrain step-2 discontinuity"), with JAX's dropout masks of both
  forwards replayed (test_torch_port_3d_models.jax_dropout_masks), and the
  same step of the port in float64 from the same state.

Tolerances of the step. Loss terms rtol 1e-4; the teacher V-Net, every
BatchNorm statistic and the heads atol 1e-5 / rtol 1e-4; pointers exactly.
Three quantities carry the train-mode V-Net's f32 rounding (ROADMAP Queue
C, "Train-mode V-Net rounding"), which is larger here than in the stage-2
test: the BatchNorm of the 2x2x1 bottleneck normalizes 8 values a channel,
and every ReLU after a train-mode BatchNorm sits where its inputs centre,
so rounding both grows and reroutes gradients. Against a float64 forward
JAX's outputs lie up to 8.0e-4 off and the port's up to 5.2e-4 (values up
to 6.6), 1.13e-3 apart; after step 2 JAX's student weights lie 4.0e-4 from
the port's float64 step and the port's f32 ones 5.8e-5. So:
- the train-mode outputs are held to JAX at atol 2e-3, and the port's may
  lie no farther from float64 than JAX's;
- the student V-Net's weights to JAX at atol 5e-4 and to the port's
  float64 step at atol 1e-4;
- both queues (the teacher's latents and descriptors) to JAX at atol 1e-4
  (4.3e-5 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.config import ISDConfig as JaxISDConfig
from arco_tpu.models import heads as jheads
from arco_tpu.models import layers as jlayers
from arco_tpu.models.factory import net_factory_3d as jax_net_factory_3d
from arco_tpu.ops import patches as jpatches
from arco_tpu.train import freeze as jfreeze
from arco_tpu.train import pretrain as jpretrain
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.compat.from_flax import (head_state_dict_from_flax,
                                         load_flax_pretrain_state,
                                         model_state_dict_from_flax)
from arco_torch.config import ISDConfig, OptimConfig
from arco_torch.models import heads, layers, net_factory_3d
from arco_torch.ops import patches
from arco_torch.train import freeze, pretrain
from arco_torch.train.checkpoint import _PRETRAIN_MODULES

from test_torch_port_3d_models import jax_dropout_masks, ncdhw, ndhwc
from test_torch_port_pretrain import (LOSS_TOL, STATE_TOL, TERMS,
                                      _assert_module, _flax_pretrain_numpy)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

S, B, NC, LABELED_BS, MAX_IT = (32, 32, 16), 2, 2, 1, 100
ISD = dict(K=6, latent_feature_size=32, output_pooling_size=4, patch_size=16)
TRAIN_TOL = dict(rtol=1e-4, atol=2e-3)
STUDENT_TOL = dict(rtol=1e-4, atol=5e-4)
F64_TOL = dict(rtol=1e-4, atol=1e-4)
QUEUE_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- patches

# (spatial, patch, step, out): the pretrain's grid at the test size, the
# full width's 20/10 grid pooled to 8 on a small volume, and one where
# neither the grid nor the pool divides
GRIDS_3D = [((32, 32, 16), 16, 8, 4), ((40, 30, 20), 20, 10, 8),
            ((17, 13, 11), 7, 3, 3)]


@pytest.mark.parametrize("spatial,patch,step,out", GRIDS_3D)
def test_pooled_patch_grid_3d_values_and_grads(spatial, patch, step, out):
    rs = np.random.RandomState(sum(spatial))
    x = rs.randn(2, *spatial, 3).astype(np.float32)

    def jfn(x):
        return jpatches.pooled_patch_grid(x, patch, step, out)
    want = np.asarray(jfn(jnp.asarray(x)))
    w = rs.randn(*want.shape).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * w))(
        jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    got = patches.pooled_patch_grid(xt, patch, step, out)
    (got * _t(w)).sum().backward()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=1e-6)


@pytest.mark.parametrize("spatial,patch,step,out", GRIDS_3D)
def test_extract_patches_3d_values_and_grads(spatial, patch, step, out):
    rs = np.random.RandomState(sum(spatial) + 1)
    x = rs.randn(2, *spatial, 3).astype(np.float32)
    want = np.asarray(jpatches.extract_patches_3d(jnp.asarray(x), patch,
                                                  step))
    w = rs.randn(*want.shape).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(
        jpatches.extract_patches_3d(x, patch, step) * w))(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    got = patches.extract_patches_3d(xt, patch, step)
    (got * _t(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=1e-6)
    # the pooled grid is the pool of these patches
    pooled = layers.adaptive_avg_pool(
        got.detach().reshape((-1,) + got.shape[2:]).movedim(-1, 1), out)
    np.testing.assert_allclose(
        pooled.movedim(1, -1).reshape((2, -1) + (out,) * 3 + (3,)).numpy(),
        patches.pooled_patch_grid(_t(x), patch, step, out).numpy(),
        atol=1e-5)


def test_the_full_width_grid_has_700_patches():
    """112x112x80 at patch 20, step 10: 10 * 10 * 7 patches."""
    assert pretrain._num_patches((112, 112, 80), 20, 10) == 700 \
        == jpretrain._num_patches((112, 112, 80), 20, 10)


@pytest.mark.parametrize("shape,out", [((6, 8, 4), 2), ((7, 5, 3), 3),
                                       ((4, 4, 2), 1), ((5, 6, 4), 4)])
def test_adaptive_avg_pool_3d(shape, out):
    x = np.random.RandomState(sum(shape)).randn(2, *shape, 3) \
        .astype(np.float32)
    want = np.asarray(jlayers.adaptive_avg_pool(jnp.asarray(x), out))
    got = layers.adaptive_avg_pool(ncdhw(x), out)
    np.testing.assert_allclose(ndhwc(got), want, atol=1e-6)


# ------------------------------------------------------------------ heads

def _head_cases():
    """(name, flax module, port module, channels-last input shape, flax
    call kwargs); LatentMLP's input is the [B, C, X, Y, Z] latent."""
    return [
        ("projection_pooled",
         jheads.ProjectionHead(proj_dim=2, output_pooling_size=4),
         heads.ProjectionHead(2, proj_dim=2, output_pooling_size=4, nd=3),
         (6, 4, 4, 4, 2), {"pre_pooled": True}),
        ("projection_pools",
         jheads.ProjectionHead(proj_dim=2, output_pooling_size=4),
         heads.ProjectionHead(2, proj_dim=2, output_pooling_size=4, nd=3),
         (3, 7, 8, 5, 2), {}),
        ("projection_linear",
         jheads.ProjectionHead(proj_dim=3, proj="linear"),
         heads.ProjectionHead(2, proj_dim=3, proj="linear", nd=3),
         (3, 4, 4, 2, 2), {}),
        ("latent_mlp_vnet",
         jheads.LatentMLP(input_channels=256, num_class=32),
         heads.LatentMLP(256, num_class=32, latent_channels=128, nd=3),
         (2, 4, 4, 2, 128), {}),
        ("latent_mlp_pool2",
         jheads.LatentMLP(input_channels=16, num_class=6, pooling_size=2),
         heads.LatentMLP(16, num_class=6, pooling_size=2, latent_channels=8,
                         nd=3), (3, 5, 4, 3, 8), {}),
        ("outputs_predictor", jheads.OutputsPredictor(num_classes=2),
         heads.OutputsPredictor(2, nd=3), (6, 4, 4, 4, 2), {}),
    ]


@pytest.mark.parametrize("case", _head_cases(), ids=lambda c: c[0])
def test_3d_heads_with_carried_weights(case):
    name, jhead, head, shape, kwargs = case
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    variables = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x), **kwargs)
    want = np.asarray(jhead.apply(variables, jnp.asarray(x), **kwargs))
    sd = head_state_dict_from_flax(_np(variables["params"]))
    if name.startswith("latent_mlp"):
        assert sd["0.weight"].shape == (head[0].out_features,
                                        head[0].in_features)
    head.load_state_dict(sd)
    xt = ncdhw(x) if name.startswith("latent_mlp") else _t(x)
    with torch.no_grad():
        got = head(xt, **kwargs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_vnet_latent_head_widths():
    """JAX's latent_head/Dense_0 of the 3D pretrain is [128, 256]: the
    V-Net's latent is feature_map[0] with 128 channels, the hidden width
    256 (arco_tpu/cli/pretrain_3d.py:72)."""
    mods = pretrain.make_isd_modules(net_factory_3d("vnet", class_num=NC),
                                     NC, latent_feature_size=512,
                                     latent_channels=256)
    assert tuple(mods.latent_head[0].weight.shape) == (256, 128)
    assert tuple(mods.latent_head[1].weight.shape) == (512, 256)
    assert isinstance(mods.outputs_head[0], torch.nn.Conv3d)
    assert isinstance(mods.outputs_predictor[0], torch.nn.Conv3d)
    u = pretrain.make_isd_modules(net_factory_3d("unet_3D", class_num=NC),
                                  NC, latent_channels=256)
    assert tuple(u.latent_head[0].weight.shape) == (256, 256)


# ----------------------------------------------------------------- freeze

_VNET_NAMES = ("one", "two", "three", "four", "five", "six", "seven",
               "eight", "nine")


def _flax_top(port_top):
    """The flax top-level module of a port V-Net top-level module."""
    if port_top == "out_conv":
        return "Conv_0"
    name = port_top[len("block_"):]
    if name.endswith("_dw"):
        return f"DownBlock_{_VNET_NAMES.index(name[:-3])}"
    if name.endswith("_up"):
        return f"UpBlock_{_VNET_NAMES.index(name[:-3]) - 4}"
    return f"VNetConvBlock_{_VNET_NAMES.index(name)}"


@pytest.mark.parametrize("enc,dec", [(True, False), (False, True)])
def test_vnet_freeze_labels_match_jax(enc, dec):
    jm = jax_net_factory_3d("vnet", in_chns=1, class_num=NC)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16,
                                                              16, 1)))
    jlabels = jfreeze.model_param_labels(v["params"], enc, dec)
    model = net_factory_3d("vnet", class_num=NC)
    labels = freeze.model_param_labels(model, enc, dec)
    tops = {n.split(".", 1)[0] for n in labels}
    assert {_flax_top(t) for t in tops} == set(jlabels)
    for pname, lab in labels.items():
        (want,) = set(jax.tree_util.tree_leaves(
            jlabels[_flax_top(pname.split(".", 1)[0])]))
        assert lab == want, pname
    trainable = freeze.apply_freeze(model, enc, dec)
    assert len(trainable) == sum(v == "train" for v in labels.values())
    assert all(p.requires_grad == (labels[n] == "train")
               for n, p in model.named_parameters())


@pytest.mark.parametrize("name", ["unet_3D", "attention_unet"])
def test_unet3d_family_refuses_a_frozen_half(name):
    jm = jax_net_factory_3d(name, in_chns=1, class_num=NC)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16,
                                                              16, 1)))
    with pytest.raises(ValueError):
        jfreeze.model_param_labels(v["params"], True, False)
    with pytest.raises(ValueError, match="encoder/decoder"):
        freeze.apply_freeze(net_factory_3d(name, class_num=NC), True, False)


# ----------------------------------------------------------- the step

def _batch():
    rs = np.random.RandomState(0)
    label = rs.randint(0, NC, size=(B,) + S).astype(np.int32)
    image = label[..., None].astype(np.float32) \
        + 0.2 * rs.randn(B, *S, 1).astype(np.float32)
    teacher = image + 0.05 * rs.randn(*image.shape).astype(np.float32)
    return image, teacher, label


def _momentum_trace(opt_state, params):
    import optax
    (trace,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return _np(trace.trace)


def _jax_run(image, teacher, label, steps):
    """JAX's states (numpy) before and after each step, its metrics, the
    dropout masks of each step's student and teacher forwards, and each
    step's train-mode V-Net outputs (logits and latent of both)."""
    cfg = JaxISDConfig(**ISD)
    jmodel = jax_net_factory_3d("vnet", in_chns=1, class_num=NC)
    mods = jpretrain.make_isd_modules(
        jmodel, NC, latent_feature_size=cfg.latent_feature_size,
        output_pooling_size=cfg.output_pooling_size, latent_channels=256)
    state = jpretrain.init_pretrain_state(jax.random.PRNGKey(0), mods, cfg,
                                          (B,) + S + (1,), MAX_IT)
    tx = jax_make_optimizer(0.01, MAX_IT, nesterov=False)
    state = state._replace(opt_state=tx.init(state.params))
    step = jpretrain.make_pretrain_step(mods, cfg, tx, LABELED_BS, NC)
    batch = {"student_image": jnp.asarray(image),
             "teacher_image": jnp.asarray(teacher),
             "label": jnp.asarray(label)}
    states, metrics, masks, outputs = [], [], [], []
    for _ in range(steps):
        s = _flax_pretrain_numpy(state)
        s["trace"] = _momentum_trace(state.opt_state, state.params)
        states.append(s)
        # the step's keys (arco_tpu/train/pretrain.py:280, :195)
        _, k_fwd = jax.random.split(state.rng)
        k_stu, k_tea = jax.random.split(k_fwd)
        ema_model = jax.tree_util.tree_map(
            lambda t, p: cfg.m * t + (1 - cfg.m) * p,
            state.ema_params["model"], state.params["model"])
        outs, step_masks = {}, {}
        for who, params, stats, key, x in (
                ("student", state.params["model"],
                 state.batch_stats["model"], k_stu, image),
                ("teacher", ema_model, state.ema_batch_stats["model"],
                 k_tea, teacher)):
            variables = {"params": params, "batch_stats": stats}
            step_masks[who] = jax_dropout_masks(jmodel, variables,
                                                x.shape, key)
            (logits, latent, _), _ = jmodel.apply(
                variables, jnp.asarray(x), train=True,
                rngs={"dropout": key}, mutable=["batch_stats"])
            outs[who] = (np.asarray(logits), np.asarray(latent))
        masks.append(step_masks)
        outputs.append(outs)
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    s = _flax_pretrain_numpy(state)
    states.append(s)
    return states, metrics, masks, outputs


def _load_momentum(state, flax_state):
    trace = flax_state["trace"]
    sds = {"model": model_state_dict_from_flax(
        trace["model"], flax_state["batch_stats"]["model"])}
    for name in ("latent_head", "latent_predictor", "outputs_head",
                 "outputs_predictor"):
        sds[name] = head_state_dict_from_flax(trace[name])
    for name, sd in sds.items():
        for pname, p in getattr(state, name).named_parameters():
            state.optimizer.state[p]["momentum_buffer"] = sd[pname].clone()


def port_state(start):
    cfg = ISDConfig(**ISD)
    optim = OptimConfig(nesterov=False)
    mods = pretrain.make_isd_modules(
        net_factory_3d("vnet", in_chns=1, class_num=NC), NC,
        latent_feature_size=cfg.latent_feature_size,
        output_pooling_size=cfg.output_pooling_size, latent_channels=256)
    state = pretrain.init_pretrain_state(mods, cfg, (B, 1) + S, optim,
                                         device="cpu",
                                         compute_dtype=torch.float32)
    load_flax_pretrain_state(state, start)
    _load_momentum(state, start)
    step = pretrain.make_pretrain_step(cfg, LABELED_BS, NC, MAX_IT, optim,
                                       device="cpu")
    return state, step


def _double(state):
    """The port state in float64, in place."""
    for name in _PRETRAIN_MODULES:
        getattr(state, name).double()
    state.queue = state.queue.double()
    state.queue_mask = state.queue_mask.double()
    for buf in state.optimizer.state.values():
        buf["momentum_buffer"] = buf["momentum_buffer"].double()
    return state


def _train_outputs(state, batch, masks, m):
    """The train-mode V-Net outputs (logits, latent) of the step's student
    and teacher forwards, on copies (the teacher after the EMA the step
    applies first), channels-last."""
    import copy
    outs = {}
    for who, model, x in (("student", state.model, "student_image"),
                          ("teacher", state.ema_model, "teacher_image")):
        net = copy.deepcopy(model)
        with torch.no_grad():
            if who == "teacher":
                for t, s in zip(net.parameters(), state.model.parameters()):
                    t.mul_(m).add_(s, alpha=1 - m)
            logits, latent, _ = net(batch[x], masks[who])
        outs[who] = (ndhwc(logits), ndhwc(latent))
    return outs


@pytest.fixture(scope="module")
def two_steps():
    """JAX's states around each of 2 steps; the port's state and train-mode
    V-Net outputs after each step from JAX's state before it, in f32 and in
    float64."""
    image, teacher, label = _batch()
    jax_states, jax_metrics, masks, jax_outputs = _jax_run(
        image, teacher, label, 2)
    batch = {"student_image": ncdhw(image), "teacher_image": ncdhw(teacher),
             "label": _t(label)}
    batch64 = {k: v.double() if v.is_floating_point() else v
               for k, v in batch.items()}
    m = ISDConfig().m
    r = {"jax": jax_states, "jax_metrics": jax_metrics,
         "jax_outputs": jax_outputs, "states": [], "metrics": [],
         "outputs": [], "states64": [], "outputs64": []}
    for before, step_masks in zip(jax_states[:-1], masks):
        state, step = port_state(before)
        r["outputs"].append(_train_outputs(state, batch, step_masks, m))
        r["metrics"].append({k: float(v) for k, v in step(
            state, batch, {"dropout": step_masks}).items()})
        r["states"].append(state)
        state, step = port_state(before)
        _double(state)
        r["outputs64"].append(_train_outputs(state, batch64, step_masks, m))
        step(state, batch64, {"dropout": step_masks})
        r["states64"].append(state)
    return r


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms(two_steps, term):
    for got, want in zip(two_steps["metrics"], two_steps["jax_metrics"]):
        np.testing.assert_allclose(got[term], want[term], **LOSS_TOL)


def test_train_mode_vnet_outputs(two_steps):
    r = two_steps
    for got, want, f64 in zip(r["outputs"], r["jax_outputs"],
                              r["outputs64"]):
        for who in ("student", "teacher"):
            for g, w, d in zip(got[who], want[who], f64[who]):
                np.testing.assert_allclose(g, w, **TRAIN_TOL)
                assert np.abs(g - d).max() <= np.abs(w - d).max()


def _after_each_step(r):
    return zip(r["states"], r["jax"][1:])


def _assert_entries(module, expected_sd, **tol):
    """Hold the named entries of ``module``'s state_dict."""
    got = module.state_dict()
    for name, want in expected_sd.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   err_msg=name, **tol)


def test_student_and_teacher_vnets(two_steps):
    for state, ja, s64 in zip(two_steps["states"], two_steps["jax"][1:],
                              two_steps["states64"]):
        want = model_state_dict_from_flax(ja["params"]["model"],
                                          ja["batch_stats"]["model"])
        assert set(state.model.state_dict()) == set(want)
        _assert_entries(state.model, {k: v for k, v in want.items()
                                      if "running" in k}, **STATE_TOL)
        params = {k for k, _ in state.model.named_parameters()}
        _assert_entries(state.model, {k: want[k] for k in params},
                        **STUDENT_TOL)
        _assert_entries(state.model, {k: v.float() for k, v in
                                      s64.model.state_dict().items()
                                      if k in params}, **F64_TOL)
        _assert_module(state.ema_model, model_state_dict_from_flax(
            ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]),
            **STATE_TOL)


def test_heads_and_teacher_heads(two_steps):
    for state, ja in _after_each_step(two_steps):
        for name in ("latent_head", "latent_predictor", "outputs_head",
                     "outputs_predictor"):
            _assert_module(getattr(state, name),
                           head_state_dict_from_flax(ja["params"][name]),
                           **STATE_TOL)
        for name in ("latent_head", "outputs_head"):
            _assert_module(getattr(state, f"ema_{name}"),
                           head_state_dict_from_flax(ja["ema_params"][name]),
                           **STATE_TOL)


def test_queues_and_pointers(two_steps):
    r = two_steps
    for k, (state, ja) in enumerate(_after_each_step(r), start=1):
        assert state.queue_ptr == ja["queue_ptr"] == 2 * k
        assert state.mask_queue_ptr == ja["mask_queue_ptr"] == 2 * k
        assert state.step == ja["step"] == k
        assert tuple(state.queue_mask.shape) == (6, 9, NC * 4 ** 3)
        np.testing.assert_allclose(state.queue.numpy(), ja["queue"],
                                   **QUEUE_TOL)
        np.testing.assert_allclose(state.queue_mask.numpy(),
                                   ja["queue_mask"], **QUEUE_TOL)
