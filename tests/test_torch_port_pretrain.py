"""Stage 1 (ISD pretraining) of the PyTorch port against the JAX package.

- ``pooled_patch_grid``, ``extract_patches_2d`` and ``adaptive_avg_pool``
  at a divisible and a non-divisible size: values and gradients, atol
  1e-6 (both sides sum the same f32 values in another order).
- Each ISD head with the flax weights carried across, atol 1e-5; and
  ``kld_batchmean``, rtol 1e-6.
- Two pretrain steps on the same batch, each from the JAX
  ``PretrainState`` before it, carried across by ``load_flax_pretrain_state``
  (and the SGD momentum trace, which that function leaves out): with both
  halves training, with each half frozen, and with
  ``latent_pooling_size=2`` (which checks the (h, w, c) flatten order of
  the latent head). Loss terms rtol 1e-4; student and teacher weights,
  BatchNorm statistics, heads and queues atol 1e-5 / rtol 1e-4 after each
  step (the tolerances of test_torch_port_step.py: convolution order
  differs between XLA:CPU and PyTorch's CPU kernels); pointers exactly; a
  frozen half bit-identical.

Why each step starts from JAX's state: the leaky ReLUs and max pools make
the second step's update discontinuous in the state. Port against port, a
1e-7 perturbation of the student after step 1 moves step 2's weights by up
to 5e-4 (1.5e-6 with both kinks replaced by smooth functions), so the
2.5e-7 by which the port and JAX differ after step 1 moved step 2's weights
apart by 7.6e-5. From the same state, step 2 agrees within 6e-7.

The sizes are those of tests/test_cli_pipeline.py (32x32, latent 32, pool
4, patch 16), with dropout-free U-Nets and f32 on both sides, except the
queue length: K=6, so that two steps of 2 keys leave both pointers at 4
(with K=2 they wrap to 0 at every step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arco_tpu.config import ISDConfig as JaxISDConfig
from arco_tpu.losses import supervised as jsupervised
from arco_tpu.models import heads as jheads
from arco_tpu.models import layers as jlayers
from arco_tpu.models.unet2d import UNet as JaxUNet
from arco_tpu.ops import patches as jpatches
from arco_tpu.train import freeze as jfreeze
from arco_tpu.train import pretrain as jpretrain
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.compat.from_flax import (head_state_dict_from_flax,
                                         load_flax_pretrain_state,
                                         unet_state_dict_from_flax)
from arco_torch.config import ISDConfig, OptimConfig
from arco_torch.losses.supervised import kld_batchmean
from arco_torch.models import heads, layers
from arco_torch.models.unet2d import UNet
from arco_torch.ops import patches
from arco_torch.train import pretrain

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

B, HW, NC, LABELED_BS, MAX_IT = 2, 32, 3, 1, 100
ISD = dict(K=6, latent_feature_size=32, output_pooling_size=4, patch_size=16)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
TERMS = ["loss", "loss_ce", "loss_dice", "loss_latent", "loss_output"]


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- patches

# (size, patch, step, out): the pretrain's grid at the test size, and one
# where neither the grid nor the pool divides
GRIDS = [(32, 16, 8, 4), (30, 12, 5, 5)]


@pytest.mark.parametrize("size,patch,step,out", GRIDS)
def test_pooled_patch_grid_values_and_grads(size, patch, step, out):
    rs = np.random.RandomState(size)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    n_p = len(patches.patch_grid_positions(size, patch, step)) ** 2
    w = rs.randn(2, n_p, out, out, 3).astype(np.float32)

    def jfn(x):
        return jpatches.pooled_patch_grid(x, patch, step, out)
    want = np.asarray(jfn(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * w))(
        jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    got = patches.pooled_patch_grid(xt, patch, step, out)
    (got * _t(w)).sum().backward()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=1e-6)


@pytest.mark.parametrize("size,patch,step,out", GRIDS)
def test_extract_patches_values_and_grads(size, patch, step, out):
    del out
    rs = np.random.RandomState(size + 1)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(jpatches.extract_patches_2d(jnp.asarray(x), patch,
                                                  step))
    w = rs.randn(*want.shape).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(
        jpatches.extract_patches_2d(x, patch, step) * w))(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    got = patches.extract_patches_2d(xt, patch, step)
    (got * _t(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=1e-6)


@pytest.mark.parametrize("patch,out", [(64, 8), (16, 4), (12, 5), (7, 3)])
def test_pool_bounds_match_jax(patch, out):
    s, e = patches._pool_bounds(patch, out)
    assert (s.tolist(), e.tolist()) == jpatches._pool_bounds(patch, out)


@pytest.mark.parametrize("n,out", [(8, 4), (7, 3), (5, 2), (4, 4)])
def test_adaptive_avg_pool(n, out):
    x = np.random.RandomState(n).randn(2, n, n, 3).astype(np.float32)
    want = np.asarray(jlayers.adaptive_avg_pool(jnp.asarray(x), out))
    got = layers.adaptive_avg_pool(_t(x).permute(0, 3, 1, 2), out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)


# ------------------------------------------------------------------ heads

def _head_cases():
    """(name, flax module, port module, input shape, flax call kwargs);
    inputs are channels-last except where the port takes NCHW."""
    return [
        ("projection_pooled",
         jheads.ProjectionHead(proj_dim=3, output_pooling_size=4),
         heads.ProjectionHead(5, proj_dim=3, output_pooling_size=4),
         (6, 4, 4, 5), {"pre_pooled": True}),
        ("projection_pools",
         jheads.ProjectionHead(proj_dim=3, output_pooling_size=4),
         heads.ProjectionHead(5, proj_dim=3, output_pooling_size=4),
         (6, 10, 10, 5), {}),
        ("projection_linear",
         jheads.ProjectionHead(proj_dim=3, proj="linear"),
         heads.ProjectionHead(5, proj_dim=3, proj="linear"),
         (6, 4, 4, 5), {}),
        ("latent_mlp", jheads.LatentMLP(input_channels=8, num_class=6),
         heads.LatentMLP(8, num_class=6), (3, 2, 2, 8), {}),
        ("latent_mlp_pool2",
         jheads.LatentMLP(input_channels=8, num_class=6, pooling_size=2),
         heads.LatentMLP(8, num_class=6, pooling_size=2), (3, 5, 5, 8), {}),
        ("latent_predictor", jheads.LatentPredictor(feature_size=6),
         heads.LatentPredictor(6), (3, 6), {}),
        ("outputs_predictor", jheads.OutputsPredictor(num_classes=4),
         heads.OutputsPredictor(4), (6, 4, 4, 4), {}),
        ("representation", jheads.RepresentationHead(output_channel=7),
         heads.RepresentationHead(5, 7), (2, 6, 6, 5), {}),
    ]


@pytest.mark.parametrize("case", _head_cases(), ids=lambda c: c[0])
def test_heads_with_carried_weights(case):
    name, jhead, head, shape, kwargs = case
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    variables = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x), **kwargs)
    want = np.asarray(jhead.apply(variables, jnp.asarray(x), **kwargs))
    head.load_state_dict(head_state_dict_from_flax(_np(variables["params"])))
    nchw = name.startswith(("latent_mlp", "representation"))
    xt = _t(x).permute(0, 3, 1, 2) if nchw else _t(x)
    with torch.no_grad():
        got = head(xt, **kwargs)
    if name == "representation":
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_kld_batchmean():
    rs = np.random.RandomState(0)
    s, t = (rs.randn(7, 9).astype(np.float32) * 3 for _ in range(2))
    want = float(jsupervised.kld_batchmean(jnp.asarray(s), jnp.asarray(t)))
    np.testing.assert_allclose(float(kld_batchmean(_t(s), _t(t))), want,
                               rtol=1e-6)


def test_descriptors_flatten_each_cell_in_hwc_order():
    """[B, P, F] descriptors: each pooled 8x8xC cell flattened (h, w, c),
    as JAX flattens its channels-last map, so the queues carry across."""
    jmods = jpretrain.make_isd_modules(JaxUNet(in_chns=1, class_num=NC), NC,
                                       output_pooling_size=4)
    rs = np.random.RandomState(5)
    logits = rs.randn(B, HW, HW, NC).astype(np.float32)
    patch = jnp.zeros((1, 16, 16, NC))
    oh = jmods.outputs_head.init(jax.random.PRNGKey(1), patch)
    op = jmods.outputs_predictor.init(jax.random.PRNGKey(2),
                                      jmods.outputs_head.apply(oh, patch))
    want = np.asarray(jpretrain._patch_descriptors(
        jmods, oh["params"], jnp.asarray(logits), 16, 8,
        predictor_params=op["params"]))
    head = heads.ProjectionHead(NC, proj_dim=NC, output_pooling_size=4)
    head.load_state_dict(head_state_dict_from_flax(_np(oh["params"])))
    pred = heads.OutputsPredictor(NC)
    pred.load_state_dict(head_state_dict_from_flax(_np(op["params"])))
    with torch.no_grad():
        got = pretrain._patch_descriptors(
            head, _t(logits).permute(0, 3, 1, 2), 16, 8, 4, pred)
    assert got.shape == want.shape == (B, 9, 4 * 4 * NC)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_logits_are_f32_outside_autocast_with_an_added_eps():
    """Cosine logits in f32 even under bf16 autocast, with + 1e-12 on the
    norms (a clamp would give a row of norm 1e-13 ten times its length)."""
    rs = np.random.RandomState(6)
    q = rs.randn(5, 16).astype(np.float32)
    q[0] *= 1e-13
    k = rs.randn(7, 16).astype(np.float32)
    want = np.asarray(jpretrain._normalized_logits(jnp.asarray(q),
                                                   jnp.asarray(k), 0.1))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = pretrain._normalized_logits(_t(q), _t(k), 0.1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert 0.5 < np.abs(want[0]).max() < 5.0


def test_ema_runs_first_from_the_pre_update_student():
    """The teacher (model, latent head, outputs head; no predictors) moves
    to m * teacher + (1 - m) * student with the student of BEFORE the
    update, then runs its own train-mode forward, which moves its
    BatchNorm statistics."""
    state, step = port_state(ISD)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.01)
    assert {t for t, _ in pretrain.EMA_PAIRS} == {
        "ema_model", "ema_latent_head", "ema_outputs_head"}
    before = {name: [p.detach().clone() for p in getattr(state, name)
                     .parameters()]
              for pair in pretrain.EMA_PAIRS for name in pair}
    stats = state.ema_model.state_dict()
    stats = {k: v.clone() for k, v in stats.items() if "running" in k}
    step(state, port_batch(*_batch()))
    m = ISD.get("m", 0.99)
    for t, s in pretrain.EMA_PAIRS:
        for got, tb, sb in zip(getattr(state, t).parameters(), before[t],
                               before[s]):
            assert torch.equal(got, tb.clone().mul_(m).add_(sb, alpha=1 - m))
    after = state.ema_model.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in stats.items())


def test_the_queues_take_the_raw_teacher_keys():
    """The enqueued rows are the teacher's raw latents and descriptors, not
    normalized ones: the logits normalize at compute time."""
    import copy
    state, step = port_state(ISD)
    image, teacher, label = _batch()
    batch = port_batch(image, teacher, label)
    step(state, batch)
    ema_model = copy.deepcopy(state.ema_model)
    with torch.no_grad():
        out, latent, _ = ema_model(batch["teacher_image"])
        k_lat = state.ema_latent_head(latent)
        desc = pretrain._patch_descriptors(state.ema_outputs_head, out, 16,
                                           8, 4)
    assert torch.equal(state.queue[:B], k_lat)
    assert torch.equal(state.queue_mask[:B], desc)
    norms = torch.linalg.vector_norm(k_lat, dim=-1)
    assert not torch.allclose(norms, torch.ones_like(norms))


# ----------------------------------------------------------- the step

CONFIGS = {"both": {}, "encoder_only": {"train_decoder": False, "k1": 0.5},
           "decoder_only": {"train_encoder": False},
           "latent_pool2": {"latent_pooling_size": 2}}


def _batch():
    rs = np.random.RandomState(0)
    label = rs.randint(0, NC, size=(B, HW, HW)).astype(np.int32)
    image = label[..., None].astype(np.float32) / (NC - 1) \
        + 0.1 * rs.randn(B, HW, HW, 1).astype(np.float32)
    teacher = image + 0.05 * rs.randn(*image.shape).astype(np.float32)
    return image, teacher, label


def _momentum_trace(opt_state, params):
    """The SGD trace of a JAX opt_state as a params-shaped numpy tree (the
    frozen half, which has no trace under multi_transform, as zeros)."""
    (trace,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return jax.tree_util.tree_map(
        lambda t, p: np.zeros(np.shape(p), np.float32)
        if isinstance(t, optax.MaskedNode) else np.array(t),
        trace.trace, params,
        is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def _flax_pretrain_numpy(s):
    return {"params": _np(s.params), "batch_stats": _np(s.batch_stats),
            "ema_params": _np(s.ema_params),
            "ema_batch_stats": _np(s.ema_batch_stats),
            "queue": np.array(s.queue), "queue_ptr": int(s.queue_ptr),
            "queue_mask": np.array(s.queue_mask),
            "mask_queue_ptr": int(s.mask_queue_ptr), "step": int(s.step),
            "trace": _momentum_trace(s.opt_state, s.params)}


def _jax_run(isd, image, teacher, label, steps):
    """The JAX states (as numpy) before and after each step, and the
    steps' metrics."""
    cfg = JaxISDConfig(**isd)
    mods = jpretrain.make_isd_modules(
        JaxUNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5), NC,
        latent_feature_size=cfg.latent_feature_size,
        latent_pooling_size=cfg.latent_pooling_size,
        output_pooling_size=cfg.output_pooling_size)
    state = jpretrain.init_pretrain_state(jax.random.PRNGKey(0), mods, cfg,
                                          (B, HW, HW, 1), MAX_IT)
    # the CLI's optimizer: no nesterov, the frozen half routed to zero
    tx = jfreeze.apply_freeze(
        jax_make_optimizer(0.01, MAX_IT, nesterov=False), state.params,
        cfg.train_encoder, cfg.train_decoder)
    state = state._replace(opt_state=tx.init(state.params))
    step = jpretrain.make_pretrain_step(mods, cfg, tx, LABELED_BS, NC)
    batch = {"student_image": jnp.asarray(image),
             "teacher_image": jnp.asarray(teacher),
             "label": jnp.asarray(label)}
    states, metrics = [_flax_pretrain_numpy(state)], []
    for _ in range(steps):
        state, m = step(state, batch)
        states.append(_flax_pretrain_numpy(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def _load_momentum(state, flax_state):
    """Set the port optimizer's momentum buffers to the JAX trace."""
    trace = flax_state["trace"]
    sds = {"model": unet_state_dict_from_flax(
        trace["model"], flax_state["batch_stats"]["model"])}
    for name in ("latent_head", "latent_predictor", "outputs_head",
                 "outputs_predictor"):
        sds[name] = head_state_dict_from_flax(trace[name])
    for name, sd in sds.items():
        for pname, p in getattr(state, name).named_parameters():
            if p.requires_grad:
                state.optimizer.state[p]["momentum_buffer"] = \
                    sd[pname].clone()


def port_state(isd, start=None):
    """A port PretrainState at the test sizes (dropout-free U-Net, f32 on
    the CPU) and its step; ``start`` (a JAX state as numpy) is carried
    across."""
    cfg = ISDConfig(**isd)
    optim = OptimConfig(nesterov=False)
    mods = pretrain.make_isd_modules(
        UNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5), NC,
        latent_feature_size=cfg.latent_feature_size,
        latent_pooling_size=cfg.latent_pooling_size,
        output_pooling_size=cfg.output_pooling_size)
    state = pretrain.init_pretrain_state(mods, cfg, (B, 1, HW, HW), optim,
                                         device="cpu",
                                         compute_dtype=torch.float32)
    if start is not None:
        load_flax_pretrain_state(state, start)
    step = pretrain.make_pretrain_step(cfg, LABELED_BS, NC, MAX_IT, optim,
                                       device="cpu")
    return state, step


def port_batch(image, teacher, label):
    nchw = lambda x: _t(x).permute(0, 3, 1, 2).contiguous()
    return {"student_image": nchw(image), "teacher_image": nchw(teacher),
            "label": _t(label)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def two_steps_each(request):
    """JAX's states before and after each of 2 steps, and the port's state
    after each step from JAX's state before it."""
    isd = {**ISD, **CONFIGS[request.param]}
    image, teacher, label = _batch()
    jax_states, jax_metrics = _jax_run(isd, image, teacher, label, 2)
    batch = port_batch(image, teacher, label)
    states, metrics = [], []
    for before in jax_states[:-1]:
        state, step = port_state(isd, before)
        _load_momentum(state, before)
        metrics.append({k: float(v) for k, v in step(state, batch).items()})
        states.append(state)
    return {"name": request.param, "isd": isd, "jax": jax_states,
            "jax_metrics": jax_metrics, "states": states,
            "metrics": metrics}


def _assert_module(module, expected_sd, **tol):
    got = module.state_dict()
    assert set(got) == set(expected_sd)
    for name, want in expected_sd.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       err_msg=name, **tol)


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms(two_steps_each, term):
    r = two_steps_each
    for got, want in zip(r["metrics"], r["jax_metrics"]):
        np.testing.assert_allclose(got[term], want[term], **LOSS_TOL)


def _after_each_step(r):
    """(port state, JAX state) after step 1 and after step 2."""
    return zip(r["states"], r["jax"][1:])


def test_student_and_teacher_unets(two_steps_each):
    for state, ja in _after_each_step(two_steps_each):
        _assert_module(state.model, unet_state_dict_from_flax(
            ja["params"]["model"], ja["batch_stats"]["model"]), **STATE_TOL)
        _assert_module(state.ema_model, unet_state_dict_from_flax(
            ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]),
            **STATE_TOL)


def test_heads_and_teacher_heads(two_steps_each):
    for state, ja in _after_each_step(two_steps_each):
        for name in ("latent_head", "latent_predictor", "outputs_head",
                     "outputs_predictor"):
            _assert_module(getattr(state, name),
                           head_state_dict_from_flax(ja["params"][name]),
                           **STATE_TOL)
        for name in ("latent_head", "outputs_head"):
            _assert_module(getattr(state, f"ema_{name}"),
                           head_state_dict_from_flax(ja["ema_params"][name]),
                           **STATE_TOL)


def test_queues_and_pointers(two_steps_each):
    r = two_steps_each
    for k, (state, ja) in enumerate(_after_each_step(r), start=1):
        assert state.queue_ptr == ja["queue_ptr"] == 2 * k
        assert state.mask_queue_ptr == ja["mask_queue_ptr"] == 2 * k
        assert state.step == ja["step"] == k
        np.testing.assert_allclose(state.queue.numpy(), ja["queue"],
                                   **STATE_TOL)
        np.testing.assert_allclose(state.queue_mask.numpy(),
                                   ja["queue_mask"], **STATE_TOL)
        # the rows not yet written still hold the initial draw
        np.testing.assert_array_equal(state.queue[2 * k:].numpy(),
                                      r["jax"][0]["queue"][2 * k:])


def test_frozen_half_is_bit_identical(two_steps_each):
    r = two_steps_each
    isd = r["isd"]
    start = r["jax"][0]
    start = unet_state_dict_from_flax(start["params"]["model"],
                                      start["batch_stats"]["model"])
    names = [n for n, _ in r["states"][0].model.named_parameters()]
    frozen = [n for n in names
              if not (isd.get("train_encoder", True) if n.startswith(
                  "encoder.") else isd.get("train_decoder", True))]
    assert bool(frozen) == (r["name"] in ("encoder_only", "decoder_only"))
    for state in r["states"]:
        got = state.model.state_dict()
        for n in names:
            assert torch.equal(got[n], start[n]) == (n in frozen), n


def test_encoder_only_loss_is_the_latent_term(two_steps_each):
    r = two_steps_each
    k1 = r["isd"].get("k1", 1.0)
    for m in r["metrics"] + r["jax_metrics"]:
        if r["name"] == "encoder_only":
            assert m["loss"] == np.float32(k1 * np.float32(m["loss_latent"]))
        else:
            np.testing.assert_allclose(
                m["loss"], m["loss_ce"] + m["loss_dice"]
                + k1 * m["loss_latent"] + m["loss_output"], rtol=1e-6)


def test_queue_init_is_normalized_along_axis_0():
    state, _ = port_state(ISD)
    for q in (state.queue, state.queue_mask):
        np.testing.assert_allclose(
            torch.linalg.vector_norm(q, dim=0).numpy(), 1.0, rtol=1e-5)
    assert state.queue.shape == (6, 32)
    assert state.queue_mask.shape == (6, 9, NC * 16)
