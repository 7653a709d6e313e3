"""The 3-D U-Net family of the PyTorch port against the flax/JAX one (CPU,
f32, TF32 off): UNet3D, UNet3DDVSemi, AttentionUNet3D and
GridAttentionBlockTORR (five attention modes, 2D and 3D), with the flax
weights carried by arco_torch.compat.from_flax and JAX's dropout masks
replayed (``flax.linen.intercept_methods``); plus the trilinear resize with
align_corners=False against JAX's ``_resize_weights`` and the InstanceNorm.

The forwards run at 32x32x16, bs 2 (the bottleneck is 2x2x1: at 16^3 it is
one voxel, which InstanceNorm maps to exactly 0, so the center would carry
no signal). Tolerances:
- the resize weights and resizes atol 1e-6; single blocks (InstanceNorm,
  the attention blocks, their BatchNorm statistics and gradients) atol
  1e-5 / rtol 1e-4 (summation order of XLA:CPU against PyTorch's CPU
  kernels);
- whole-model forwards, eval and train mode, atol 1e-4 / rtol 1e-4: the
  InstanceNorms of the 4x4x2 and 2x2x1 maps amplify f32 rounding, so JAX's
  outputs and the port's each lie 2e-5 to 3e-5 from a float64 forward of
  the same weights (values up to ~5), 2.4e-5 to 5.6e-5 apart (1.2e-5 at
  16^3);
- gradients of whole models at 16^3, every weight and the input, atol a
  fraction of the model's largest gradient: 1e-5 for UNet3D and
  UNet3DDVSemi (4.7e-6 measured). The attention U-Net's differ by up to
  2.2e-2 of it, spread over the whole network, while its blocks' own
  gradients agree within 1e-6 (test_attention_blocks_in_train_mode): its
  ReLUs sit right after train-mode BatchNorms, whose outputs centre on the
  kink, and its max pools pick among near-ties, so the 1e-6 forward
  differences reroute gradients (ROADMAP Queue C). It is held at 5e-2.
  At 32x32x16 UNet3D's gradients too differ by 3%, for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from arco_tpu.models import unet3d as junet3d
from arco_tpu.models.factory import net_factory_3d as jax_net_factory_3d
from arco_tpu.ops import interpolate as jinterp

from arco_torch.compat.from_flax import (_bn, _conv,
                                         model_state_dict_from_flax)
from arco_torch.models import net_factory_3d, unet3d
from arco_torch.ops import interpolate

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
TOL = dict(rtol=1e-4, atol=1e-5)
# the models' outputs: see the module docstring
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
S, B, NC = (32, 32, 16), 2, 2
MODELS = ("unet_3D", "unet_3D_dv_semi", "attention_unet")


def to_port(x):
    """Channels-last numpy -> [B, C, *spatial] tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def to_jax_layout(t):
    return t.detach().movedim(1, -1).numpy()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_masks(jmodel, variables, x, key):
    """Every dropout keep-mask a train-mode flax forward draws with dropout
    key ``key``, in call order, as [B, C, *spatial] bool tensors: each call
    is intercepted, run once on ones and replayed on its input."""
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
        jmodel.apply(variables, x, train=True, rngs={"dropout": key},
                     mutable=["batch_stats"])
    return masks


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("n_in,n_out", [(2, 4), (4, 8), (5, 3), (7, 16),
                                        (8, 2), (3, 3), (1, 4)])
def test_resize_weights_without_align_corners(n_in, n_out):
    """The port's resize on a basis of one-hot rows gives JAX's weight
    matrix W[out, in] (torch's rule clamps the source index at 0 and at the
    last row; JAX clips it to [0, n - 1])."""
    basis = torch.eye(n_in).reshape(n_in, 1, n_in, 1)
    got = interpolate.resize_bilinear(basis, (n_out, 1),
                                      align_corners=False)
    want = np.asarray(jinterp._resize_weights(n_in, n_out, False))
    np.testing.assert_allclose(got[:, 0, :, 0].numpy().T, want, atol=1e-6)


@pytest.mark.parametrize("shape,out", [((2, 4, 4, 2, 3), (8, 8, 4)),
                                       ((1, 5, 6, 3, 2), (7, 4, 6)),
                                       ((2, 6, 5, 2), (12, 3))])
def test_trilinear_without_align_corners_matches_jax(shape, out):
    x = np.random.RandomState(len(out) + shape[1]).randn(*shape) \
        .astype(np.float32)
    want = np.asarray(jinterp.resize_bilinear(jnp.asarray(x), out,
                                              align_corners=False))
    got = interpolate.resize_bilinear(to_port(x), out, align_corners=False)
    np.testing.assert_allclose(to_jax_layout(got), want, atol=1e-6)


# --------------------------------------------------------- InstanceNorm

def test_instance_norm_matches_jax_in_f32_and_bf16():
    """f32 statistics, no affine, eps 1e-5, the result in the input's
    dtype; under bf16 autocast the statistics stay f32."""
    x = (np.random.RandomState(0).randn(2, 4, 3, 2, 5) * 3 + 1) \
        .astype(np.float32)
    norm = unet3d.InstanceNorm()
    want = np.asarray(junet3d.InstanceNorm().apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(to_jax_layout(norm(to_port(x))), want,
                               **TOL)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_b = np.asarray(junet3d.InstanceNorm().apply({}, xb)
                        .astype(jnp.float32))
    tb = to_port(x).bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = norm(tb)
    assert got.dtype == torch.bfloat16
    # the same f32 normalization rounded once to bf16 (ulp 2^-7 at 1-2)
    np.testing.assert_allclose(to_jax_layout(got.float()), want_b,
                               atol=2 ** -6)
    assert torch.equal(got, norm(tb.float()).bfloat16())
    # a one-voxel map normalizes to 0, as in JAX
    one = np.random.RandomState(1).randn(2, 1, 1, 1, 3).astype(np.float32)
    assert not norm(to_port(one)).any()
    np.testing.assert_array_equal(
        np.asarray(junet3d.InstanceNorm().apply({}, jnp.asarray(one))), 0)


# ---------------------------------------------------------------- models

@pytest.fixture(scope="module", params=MODELS)
def model_pair(request):
    """(name, flax model, its variables, port model with the weights
    carried, input)."""
    name = request.param
    x = np.random.RandomState(3).randn(B, *S, 1).astype(np.float32)
    jm = jax_net_factory_3d(name, in_chns=1, class_num=NC)
    v = jm.init({"params": jax.random.PRNGKey(4),
                 "dropout": jax.random.PRNGKey(0)}, jnp.asarray(x))
    tm = net_factory_3d(name, in_chns=1, class_num=NC)
    tm.load_state_dict(model_state_dict_from_flax(
        _np(v["params"]), _np(v.get("batch_stats", {}))))
    return name, jm, v, tm, x


def _outputs(name, out):
    """The outputs to compare: logits, latent and the decoder maps, or the
    dv_semi model's four supervision outputs."""
    if name == "unet_3D_dv_semi":
        return list(out)
    logits, latent, fmap = out
    return [logits, latent] + list(fmap)


def test_eval_forward(model_pair):
    name, jm, v, tm, x = model_pair
    want = _outputs(name, jm.apply(v, jnp.asarray(x), train=False))
    tm.eval()
    with torch.no_grad():
        got = _outputs(name, tm(to_port(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_jax_layout(g), np.asarray(w),
                                   **MODEL_TOL)


def _train_pair(model_pair, seed=5):
    """JAX's train-mode outputs and batch statistics, the port's from the
    same masks, and the masks."""
    name, jm, v, tm, x = model_pair
    key = jax.random.PRNGKey(seed)
    masks = jax_masks(jm, v, jnp.asarray(x), key)
    out, upd = jm.apply(v, jnp.asarray(x), train=True,
                        rngs={"dropout": key}, mutable=["batch_stats"])
    tm.load_state_dict(model_state_dict_from_flax(
        _np(v["params"]), _np(v.get("batch_stats", {}))))
    tm.train()
    if name == "unet_3D_dv_semi":
        # channel masks: constant over space, handed over as [B, C, 1, 1, 1]
        for m in masks:
            assert torch.equal(m, m[..., :1, :1, :1].expand_as(m))
        masks = [m[..., :1, :1, :1].contiguous() for m in masks]
    return out, upd, masks


def test_train_forward_with_jax_masks(model_pair):
    name, jm, v, tm, x = model_pair
    want, upd, masks = _train_pair(model_pair)
    assert len(masks) == {"unet_3D": 2, "unet_3D_dv_semi": 4,
                          "attention_unet": 0}[name]
    # the masks have the shapes the port itself draws
    drawn = tm.draw_dropout_masks((B, 1) + S)
    assert [m.shape for m in drawn] == [m.shape for m in masks]
    with torch.no_grad():
        got = _outputs(name, tm(to_port(x), masks or None))
    for g, w in zip(got, _outputs(name, want)):
        np.testing.assert_allclose(to_jax_layout(g), np.asarray(w),
                                   **MODEL_TOL)
    if name == "attention_unet":
        sd = model_state_dict_from_flax(_np(v["params"]),
                                        _np(upd["batch_stats"]))
        got_sd = tm.state_dict()
        stats = [k for k in sd if "running" in k]
        assert len(stats) == 3 * 3 * 2
        for k in stats:
            np.testing.assert_allclose(got_sd[k].numpy(), sd[k].numpy(),
                                       err_msg=k, **TOL)


def _grad_outputs(name, out):
    """The outputs the gradient tests differentiate: the logits, or the
    dv_semi model's four supervision outputs (each reaches its own head)."""
    return list(out) if name == "unet_3D_dv_semi" else [out[0]]


# the largest gradient difference allowed, relative to the model's largest
# gradient (module docstring)
GRAD_TOL = {"unet_3D": 1e-5, "unet_3D_dv_semi": 1e-5,
            "attention_unet": 5e-2}


@pytest.mark.parametrize("name", MODELS)
def test_train_gradients(name):
    """Gradients of sum_k sum(output_k * w_k) in train mode, for every
    weight and the input, at 16^3 (bs 2), with JAX's dropout masks."""
    size = (16, 16, 16)
    x = np.random.RandomState(3).randn(B, *size, 1).astype(np.float32)
    jm = jax_net_factory_3d(name, in_chns=1, class_num=NC)
    v = jm.init({"params": jax.random.PRNGKey(4),
                 "dropout": jax.random.PRNGKey(0)}, jnp.asarray(x))
    stats = _np(v.get("batch_stats", {}))
    tm = net_factory_3d(name, in_chns=1, class_num=NC)
    tm.load_state_dict(model_state_dict_from_flax(_np(v["params"]), stats))
    key = jax.random.PRNGKey(5)
    masks = jax_masks(jm, v, jnp.asarray(x), key)
    if name == "unet_3D_dv_semi":
        masks = [m[..., :1, :1, :1].contiguous() for m in masks]
    w = np.random.RandomState(6).randn(4, B, *size, NC).astype(np.float32)

    def loss(params, x):
        out = jm.apply({**v, "params": params}, x, train=True,
                       rngs={"dropout": key}, mutable=["batch_stats"])[0]
        return sum(jnp.sum(o * w[i])
                   for i, o in enumerate(_grad_outputs(name, out)))
    g_params, g_x = jax.grad(loss, argnums=(0, 1))(v["params"],
                                                   jnp.asarray(x))
    want = model_state_dict_from_flax(_np(g_params), stats)
    xt = to_port(x).requires_grad_()
    out = tm(xt, masks or None)
    sum((o * to_port(w[i])).sum()
        for i, o in enumerate(_grad_outputs(name, out))).backward()
    pairs = [("input", to_jax_layout(xt.grad), np.asarray(g_x))] + [
        (pname, p.grad.numpy(), want[pname].numpy())
        for pname, p in tm.named_parameters()]
    scale = max(float(np.abs(w_).max()) for _, _, w_ in pairs)
    for pname, got, w_ in pairs:
        np.testing.assert_allclose(got, w_, rtol=0,
                                   atol=GRAD_TOL[name] * scale,
                                   err_msg=pname)


@pytest.mark.parametrize("block", ["grid", "multi"])
def test_attention_blocks_in_train_mode(block):
    """GridAttentionBlock3D and MultiAttentionBlock alone: train-mode
    outputs, BatchNorm statistics and the gradients of x and g."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 8, 4, 16).astype(np.float32)
    g = rs.randn(2, 4, 4, 2, 32).astype(np.float32)
    if block == "grid":
        jb = junet3d.GridAttentionBlock3D(16)
        tb = unet3d.GridAttentionBlock3D(16, 32, 16)
    else:
        jb = junet3d.MultiAttentionBlock(16)
        tb = unet3d.MultiAttentionBlock(16, 32, 16)
    v = jb.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(g))
    p, st = _np(v["params"]), _np(v["batch_stats"])

    def grid_sd(gp, gs, pre):
        sd = {}
        for j, part in enumerate(("theta", "phi", "psi", "W.0")):
            sd.update({f"{pre}{part}.{k}": t
                       for k, t in _conv(gp[f"Conv_{j}"]).items()})
        sd.update({f"{pre}W.1.{k}": t
                   for k, t in _bn(gp["BatchNorm_0"],
                                   gs["BatchNorm_0"]).items()})
        return sd
    if block == "grid":
        sd = grid_sd(p, st, "")
    else:
        sd = {}
        for i in range(2):
            sd.update(grid_sd(p[f"GridAttentionBlock3D_{i}"],
                              st[f"GridAttentionBlock3D_{i}"],
                              f"gate_block_{i + 1}."))
        for k, t in _conv(p["Conv_0"]).items():
            sd[f"combine_gates.0.{k}"] = t
        for k, t in _bn(p["BatchNorm_0"], st["BatchNorm_0"]).items():
            sd[f"combine_gates.1.{k}"] = t
    tb.load_state_dict(sd)
    first = lambda y: y[0] if block == "grid" else y
    w = rs.randn(*x.shape).astype(np.float32)

    def loss(x, g):
        y, _ = jb.apply(v, x, g, mutable=["batch_stats"])
        return jnp.sum(first(y) * w)
    y, upd = jb.apply(v, jnp.asarray(x), jnp.asarray(g),
                      mutable=["batch_stats"])
    gx, gg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    xt, gt = to_port(x).requires_grad_(), to_port(g).requires_grad_()
    ty = first(tb(xt, gt))
    np.testing.assert_allclose(to_jax_layout(ty), np.asarray(first(y)),
                               **TOL)
    (ty * to_port(w)).sum().backward()
    for got, want in ((xt.grad, gx), (gt.grad, gg)):
        np.testing.assert_allclose(to_jax_layout(got), np.asarray(want),
                                   **TOL)
    bn = tb.W[1] if block == "grid" else tb.combine_gates[1]
    s = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(s["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(s["var"]), **TOL)


# --------------------------------------------------- TORR grid attention

MODES = ("concatenation_sigmoid", "concatenation_softmax",
         "concatenation_mean", "concatenation_mean_flow",
         "concatenation_range_normalise")


def _torr_state_dict(params, stats, order):
    """flax GridAttentionBlockTORR params -> the port block's state_dict:
    its Conv_i are the enabled projections in creation order."""
    sd = {}
    for i, part in enumerate(order):
        sd.update({f"{part}.{k}": t
                   for k, t in _conv(params[f"Conv_{i}"]).items()})
    if "BatchNorm_0" in params:
        sd.update({f"W.1.{k}": t for k, t in _bn(
            params["BatchNorm_0"], stats["BatchNorm_0"]).items()})
    return sd


TORR_CASES = [(mode, nd, {}) for nd in (2, 3) for mode in MODES] + [
    ("concatenation_sigmoid", 3, {"sub_sample": 2}),
    ("concatenation", 2, {"use_theta": False, "bn_layer": False}),
    ("concatenation_softmax", 3, {"use_phi": False, "use_w": False})]


@pytest.mark.parametrize("mode,nd,kw", TORR_CASES,
                         ids=lambda c: str(c))
def test_grid_attention_torr(mode, nd, kw):
    """Forward in train mode (BatchNorm on batch statistics) with its
    running statistics, and the input gradients, against JAX. x [2,
    8^nd, 4] and a coarser gating map g [2, 4^nd, c_g] (resized with
    align_corners=True)."""
    rs = np.random.RandomState(len(mode) + nd)
    inter = 4 if not kw.get("use_theta", True) else 3
    c_g = inter if not kw.get("use_phi", True) else 6
    x = rs.randn(2, *(8,) * nd, 4).astype(np.float32)
    g = rs.randn(2, *(4,) * nd, c_g).astype(np.float32)
    jb = junet3d.GridAttentionBlockTORR(inter, mode=mode, **kw)
    v = jb.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(g))
    params = _np(v["params"])
    order = [p for p, on in (("theta", kw.get("use_theta", True)),
                             ("phi", kw.get("use_phi", True)),
                             ("psi", True),
                             ("W.0" if kw.get("bn_layer", True) else "W",
                              kw.get("use_w", True))) if on]
    # the flax init puts psi's bias at 3.0 / 10.0 / 0.0, as the port does
    psi = f"Conv_{order.index('psi')}"
    assert float(params[psi]["bias"][0]) == {
        "concatenation_sigmoid": 3.0,
        "concatenation_softmax": 10.0}.get(mode, 0.0)
    tb = unet3d.GridAttentionBlockTORR(4, c_g, inter, mode=mode, nd=nd, **kw)
    assert float(tb.psi.bias.detach()[0]) == float(params[psi]["bias"][0])
    if mode in ("concatenation_mean", "concatenation_mean_flow"):
        # keep the normalizing sums away from 0 (both sides the same)
        params[psi]["bias"] = np.full_like(params[psi]["bias"], 2.0)
    tb.load_state_dict(_torr_state_dict(params, _np(v.get("batch_stats",
                                                          {})), order))
    w = rs.randn(2, *(8,) * nd, 4).astype(np.float32)
    variables = {**v, "params": params}

    def loss(x, g):
        (y, att), _ = jb.apply(variables, x, g, mutable=["batch_stats"])
        return jnp.sum(y * w) + jnp.sum(att)
    (y, att), upd = jb.apply(variables, jnp.asarray(x), jnp.asarray(g),
                             mutable=["batch_stats"])
    gx, gg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))

    xt, gt = to_port(x).requires_grad_(), to_port(g).requires_grad_()
    ty, tatt = tb(xt, gt)
    np.testing.assert_allclose(to_jax_layout(ty), np.asarray(y), **TOL)
    np.testing.assert_allclose(to_jax_layout(tatt), np.asarray(att), **TOL)
    ((ty * to_port(w)).sum() + tatt.sum()).backward()
    for got, want in ((xt.grad, gx), (gt.grad, gg)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            to_jax_layout(got), want, rtol=1e-3,
            atol=1e-5 * max(float(np.abs(want).max()), 1.0))
    if "BatchNorm_0" in upd.get("batch_stats", {}):
        s = upd["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(tb.W[1].running_mean.numpy(),
                                   np.asarray(s["mean"]), **TOL)
        np.testing.assert_allclose(tb.W[1].running_var.numpy(),
                                   np.asarray(s["var"]), **TOL)


def test_torr_refuses_an_unknown_mode():
    with pytest.raises(NotImplementedError):
        unet3d.GridAttentionBlockTORR(4, 4, 4, mode="concatenation_bogus")
