"""The port's pretrained-weight importers (arco_torch/compat/pretrained.py)
and ``--pretrained_path`` against arco_tpu/compat/pretrained.py, on the CPU.

- The six tests of tests/test_pretrained_import.py, on the port's models:
  the R50+ViT npz round trip with a resized position embedding, the Swin
  round trip with resized bias tables and the mirrored decoder, the
  PatchMerging permutation (held against the port's own PatchMerging), the
  EfficientNet-B3 round trip, and the merge's shape-mismatch and
  unknown-key errors. The synthetic files carry the reference's key names
  and shapes (that module's builders).
- The oracle: one model's seeded weights (flax's shapes, carried across with
  compat/from_flax.py) and one synthetic file go through JAX's
  ``load_pretrained`` and the port's; JAX's merged params carried across
  equal the port's state dict tensor for tensor, exactly (the position
  embedding and the bias tables come from the same ``scipy.ndimage.zoom``
  on both sides). Then one eval forward on the loaded weights, JAX in
  float64 against the port in float64, at test_torch_port_zoo2d.py's
  float64 tolerance.
- The CLIs: ``pretrain_2d`` loads the file into student and teacher
  (BatchNorm statistics included) and does not load on its own resume;
  ``train_arco_2d`` loads it unless ``--resume`` loaded stage 1, and raises
  JAX's error for a model without an importer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pretrained_import as jtests
from test_torch_port_zoo2d import F64_TOL, _close, random_variables, to_nhwc

from arco_tpu.compat import pretrained as jpre
from arco_tpu.models import efficientunet as jeffi
from arco_tpu.models import swin_unet as jswin
from arco_tpu.models import transunet as jvit

from arco_torch.cli import pretrain_2d, train_arco_2d
from arco_torch.compat import from_flax, pretrained
from arco_torch.data.synthetic import make_acdc_like
from arco_torch.models import efficientunet, swin_unet, transunet

torch.set_num_threads(1)

SWIN = dict(embed_dim=24, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
            window_size=4)
SWIN_KW = dict(depths=(1, 1, 1, 1), window_size=4, img_size=32)
VIT = dict(hidden=32, num_layers=12, num_heads=2, mlp_dim=64)


def _effnet_sd(rng):
    """A synthetic lukemelas EfficientNet-B3 state dict (the reference's
    names and shapes) with random weights and BatchNorm statistics."""
    B0, rf, rr = efficientunet.B0_BLOCKS, efficientunet._round_filters, \
        efficientunet._round_repeats
    sd = {}

    def bn(name, ch):
        sd[f"{name}.weight"] = 1 + 0.1 * rng.randn(ch)
        sd[f"{name}.bias"] = 0.1 * rng.randn(ch)
        sd[f"{name}.running_mean"] = 0.1 * rng.randn(ch)
        sd[f"{name}.running_var"] = 1 + 0.5 * rng.rand(ch)

    stem = rf(32, 1.2)
    sd["_conv_stem.weight"] = jtests.rand(rng, stem, 3, 3, 3)
    bn("_bn0", stem)
    i, cin = 0, stem
    for (e, c, r, _s, k) in B0:
        cout = rf(c, 1.2)
        for _ in range(rr(r, 1.4)):
            pre, exp = f"_blocks.{i}", cin * e
            if e != 1:
                sd[f"{pre}._expand_conv.weight"] = jtests.rand(rng, exp, cin,
                                                               1, 1)
                bn(f"{pre}._bn0", exp)
            sd[f"{pre}._depthwise_conv.weight"] = jtests.rand(rng, exp, 1, k,
                                                              k)
            se = max(1, int(cin * 0.25))
            sd[f"{pre}._se_reduce.weight"] = jtests.rand(rng, se, exp, 1, 1)
            sd[f"{pre}._se_reduce.bias"] = 0.1 * rng.randn(se)
            sd[f"{pre}._se_expand.weight"] = jtests.rand(rng, exp, se, 1, 1)
            sd[f"{pre}._se_expand.bias"] = 0.1 * rng.randn(exp)
            sd[f"{pre}._project_conv.weight"] = jtests.rand(rng, cout, exp,
                                                            1, 1)
            bn(f"{pre}._bn1", exp)
            bn(f"{pre}._bn2", cout)
            cin, i = cout, i + 1
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}


def _swin_sd(rng):
    """tests/test_pretrained_import.py's Swin dict (window-7 bias tables)
    as torch tensors."""
    sd = jtests.TestSwinImport()._make_sd(rng, depths=SWIN["depths"],
                                          heads=SWIN["num_heads"],
                                          with_wrapper=False)
    return {"model": {k: torch.from_numpy(v.a) for k, v in sd.items()}}


def _forward(model, x):
    model.eval()
    with torch.no_grad():
        return model(x)[0]


# ---------------------------------------------- the importers' round trips

def test_vit_npz_roundtrip_into_transunet():
    """The synthetic R50+ViT npz (default stem (3, 4, 9), 2 transformer
    layers, 14x14 + class-token position embedding, so the resize runs)
    imports into VisionTransformerSeg and the model runs."""
    hidden, mlp, heads, hd = 32, 64, 4, 8
    w = jtests._full_vit_npz(hidden, mlp, heads, hd, n_layers=2)
    torch.manual_seed(0)
    m = transunet.VisionTransformerSeg(
        img_size=64, num_classes=3, hidden=hidden, num_layers=2,
        num_heads=heads, mlp_dim=mlp, decoder_channels=(16, 8, 8, 8))
    n_tokens = m.pos_embedding.shape[1]
    sub = pretrained.convert_vit_npz(w, n_tokens, num_layers=2)
    m.load_state_dict(pretrained.deep_merge(m.state_dict(), sub))
    logits = _forward(m, torch.ones(1, 1, 64, 64))
    assert logits.shape == (1, 3, 64, 64)
    assert torch.isfinite(logits).all()
    # golden leaf: an npz kernel lands transposed at the port's name
    np.testing.assert_array_equal(
        m.layers[0].fc1.weight.detach().numpy(),
        w["Transformer/encoderblock_0/MlpBlock_3/Dense_0/kernel"].T)
    # 197 tokens with the class token -> the model's 4x4 grid
    assert m.pos_embedding.shape == (1, n_tokens, hidden) and n_tokens == 16


def test_swin_roundtrip(rng):
    torch.manual_seed(0)
    m = swin_unet.SwinUnet(img_size=32, num_classes=4, in_chns=1, **SWIN)
    sub = pretrained.convert_swin_state_dict(_swin_sd(rng), **SWIN_KW)
    m.load_state_dict(pretrained.deep_merge(m.state_dict(), sub))
    # encoder AND mirrored decoder blocks covered
    assert "layers.0.0.norm1.weight" in sub
    assert "layers_up.0.0.norm1.weight" in sub
    # bias table resized from window 7 -> the stage-0 effective window
    assert sub["layers.0.0.attn.relative_position_bias_table"].shape == \
        ((2 * 4 - 1) ** 2, 2)
    assert _forward(m, torch.ones(1, 1, 32, 32)).shape == (1, 4, 32, 32)


def test_merge_perm_consistency(rng):
    """The reference's PatchMerging concatenates [x0, x1, x2, x3] = [h0w0,
    h1w0, h0w1, h1w1]; the port's flattens (row, col). The permuted
    reduction and norm, applied by the port's own PatchMerging, equal the
    reference's arithmetic on the same 2x2 neighbourhood."""
    c = 4
    w = jtests.rand(rng, 2 * c, 4 * c)                # torch [out, in]
    x = torch.from_numpy(jtests.rand(rng, 1, 2, 2, c) * 50)   # [B, H, W, C]
    x0, x1, x2, x3 = x[0, 0, 0], x[0, 1, 0], x[0, 0, 1], x[0, 1, 1]
    ref_in = torch.cat([x0, x1, x2, x3])
    gamma = 1 + jtests.rand(rng, 4 * c) * 10
    beta = jtests.rand(rng, 4 * c) * 10
    ref = torch.nn.functional.layer_norm(
        ref_in, (4 * c,), torch.from_numpy(gamma), torch.from_numpy(beta),
        1e-6) @ torch.from_numpy(w).T

    merge = swin_unet.PatchMerging(c)
    merge.load_state_dict({
        "norm.weight": torch.from_numpy(pretrained._perm4c(gamma)),
        "norm.bias": torch.from_numpy(pretrained._perm4c(beta)),
        "reduction.weight": torch.from_numpy(pretrained._perm4c(w, axis=1))})
    with torch.no_grad():
        got = merge(x)[0, 0, 0]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_efficientnet_b3_roundtrip(rng):
    sd = _effnet_sd(rng)
    sub = pretrained.convert_efficientnet_state_dict(sd, 1.4, in_chns=1)
    torch.manual_seed(0)
    m = efficientunet.EffiUNet(num_classes=4, in_chns=1)
    m.load_state_dict(pretrained.deep_merge(m.state_dict(), sub))
    assert _forward(m, torch.ones(1, 1, 64, 64)).shape == (1, 4, 64, 64)
    # the RGB stem summed over its input channels, the statistics copied
    torch.testing.assert_close(m.encoder.stem_conv.weight.detach(),
                               sd["_conv_stem.weight"].sum(1, keepdim=True))
    assert torch.equal(m.encoder.blocks[3].project_bn.running_var,
                       sd["_blocks.3._bn2.running_var"])


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        pretrained.deep_merge({"a": torch.zeros(2, 2)},
                              {"a": torch.zeros(3, 3)})


def test_unknown_key_raises():
    with pytest.raises(KeyError):
        pretrained.deep_merge({"a": torch.zeros(2)}, {"b": torch.zeros(2)})


# ---------------------------------------------- the oracle: JAX's loader

# key -> (flax module of a dtype, port module, input size, file writer,
# converter kwargs)
ORACLE = {
    "ViT_Seg": (
        lambda dt: jvit.VisionTransformerSeg(num_classes=4, dtype=dt, **VIT),
        lambda: transunet.VisionTransformerSeg(img_size=64, num_classes=4,
                                               **VIT), 64,
        lambda rng, path: np.savez(path, **jtests._full_vit_npz(
            VIT["hidden"], VIT["mlp_dim"], VIT["num_heads"],
            VIT["hidden"] // VIT["num_heads"], n_layers=12)), {}),
    "swin_unet": (
        lambda dt: jswin.SwinUnet(num_classes=4, in_chns=1, dtype=dt,
                                  **SWIN),
        lambda: swin_unet.SwinUnet(img_size=32, num_classes=4, in_chns=1,
                                   **SWIN), 32,
        lambda rng, path: torch.save(_swin_sd(rng), path), SWIN_KW),
    "efficient_unet": (
        lambda dt: jeffi.EffiUNet(num_classes=4, in_chns=1, dtype=dt),
        lambda: efficientunet.EffiUNet(num_classes=4, in_chns=1), 64,
        lambda rng, path: torch.save({"state_dict": _effnet_sd(rng)}, path),
        {}),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree) if tree else tree


@pytest.fixture(scope="module", params=list(ORACLE))
def loaded(request, tmp_path_factory):
    """One model loaded by both packages from the same weights and file:
    (key, JAX's merged params and statistics, the port's model, the
    input)."""
    key = request.param
    jfac, tfac, hw, write, kw = ORACLE[key]
    path = str(tmp_path_factory.mktemp("pre") / (
        f"{key}.npz" if key == "ViT_Seg" else f"{key}.pth"))
    write(np.random.RandomState(3), path)
    x = np.random.RandomState(1).randn(2, hw, hw, 1).astype(np.float32)
    params, stats = random_variables(jfac(jnp.float32), jnp.asarray(x))
    model = tfac()
    model.load_state_dict(from_flax.model_state_dict_from_flax(params,
                                                               stats))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mp, ms = jpre.load_pretrained(key, path, params, stats or None, **kw)
    names = pretrained.load_pretrained(key, path, model, **kw)
    return dict(key=key, params=_np_tree(mp), stats=_np_tree(ms),
                model=model, x=x, before=before, names=names)


def test_loaded_weights_equal_jaxs(loaded):
    """Tensor for tensor against JAX's merge carried across; what the port
    reports as loaded is what changed."""
    want = from_flax.model_state_dict_from_flax(loaded["params"],
                                                loaded["stats"] or {})
    got = loaded["model"].state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k].to(v.dtype)), k
    changed = {k for k, v in got.items()
               if not torch.equal(v, loaded["before"][k])}
    assert changed == set(loaded["names"])
    if loaded["key"] == "efficient_unet":
        assert "encoder.stem_bn.running_var" in changed


def test_forward_on_loaded_weights_matches_jax(loaded):
    """One eval forward, JAX in float64 against the port in float64."""
    jfac = ORACLE[loaded["key"]][0]
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t)
        variables = {"params": to64(loaded["params"])}
        if loaded["stats"]:
            variables["batch_stats"] = to64(loaded["stats"])
        jmodel = jfac(jnp.float64)
        want = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, rngs={"dropout": jax.random.PRNGKey(0)})[0])(
            variables, jnp.asarray(loaded["x"], jnp.float64))
    model = loaded["model"].double()
    got = _forward(model, torch.from_numpy(
        np.moveaxis(loaded["x"], -1, 1).astype(np.float64)))
    loaded["model"].float()
    _close(to_nhwc(got), np.asarray(want), what=loaded["key"], **F64_TOL)


def test_no_importer_raises_as_jax():
    with pytest.raises(ValueError) as want:
        jpre.load_pretrained("unet", "w.npz", {})
    with pytest.raises(ValueError) as got:
        pretrained.load_pretrained("unet", "w.npz", torch.nn.Linear(1, 1))
    assert str(got.value) == str(want.value)


# ---------------------------------------------- the CLIs

HW, NC = 32, 3
SMALL_ISD = ["--isd.K", "2", "--isd.latent_feature_size", "32",
             "--isd.output_pooling_size", "4", "--isd.patch_size", "16"]
SMALL_ARCO = ["--arco.K", "2", "--arco.num_queries", "16",
              "--arco.num_negatives", "8", "--arco.memobank_size", "64",
              "--arco.memobank_size_bg", "64", "--arco.memobank_enqueue",
              "16", "--arco.topk", "2"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("pretrained_cli")
    data = make_acdc_like(str(base / "ACDC"), n_train=30, n_val=1,
                          size=(HW, HW), num_classes=NC)
    path = str(base / "effnet.pth")
    torch.save({"state_dict": _effnet_sd(np.random.RandomState(5))}, path)
    return {"data": data, "model_dir": str(base / "model"), "pth": path}


def _argv(tree, exp, iterations, *extra):
    return ["--root_path", tree["data"], "--exp", exp, "--labeled_num", "1",
            "--device", "cpu", "--patch_size", str(HW), str(HW),
            "--num_classes", str(NC), "--batch_size", "2", "--labeled_bs",
            "1", "--snapshot_dir", tree["model_dir"], "--compute_dtype",
            "float32", "--seed", "7", "--log_every", "1", "--ckpt_every",
            "2", "--max_iterations", str(iterations)] + list(extra)


def _state(tree, exp, model, name):
    snap = os.path.join(tree["model_dir"], f"{exp}_1_labeledfinal", model)
    return torch.load(os.path.join(snap, name, "state.pt"),
                      weights_only=True), snap


def _refuse(*args, **kwargs):
    raise AssertionError("load_pretrained called")


def test_pretrain_2d_loads_into_student_and_teacher(tree):
    pretrain_2d.main(_argv(tree, "ACDC/effpre", 0, "--model",
                           "efficient_unet", "--pretrained_path",
                           tree["pth"]) + SMALL_ISD)
    state, snap = _state(tree, "ACDC/effpre", "efficient_unet", "iter_0")
    sd = torch.load(tree["pth"], weights_only=True)["state_dict"]
    want = pretrained.convert_efficientnet_state_dict(sd, in_chns=1)
    for name in ("model", "ema_model"):
        for k, v in want.items():
            assert torch.equal(state[name][k], v), f"{name}.{k}"
    with open(os.path.join(snap, "log.txt")) as f:
        assert f"loaded pretrained backbone from {tree['pth']}" in f.read()


def test_pretrain_2d_does_not_load_on_its_own_resume(tree, monkeypatch):
    argv = lambda n: _argv(tree, "ACDC/effres", n, "--model",
                           "efficient_unet", "--pretrained_path",
                           tree["pth"]) + SMALL_ISD
    pretrain_2d.main(argv(2))
    monkeypatch.setattr(pretrain_2d, "load_pretrained", _refuse)
    pretrain_2d.main(argv(3))
    state, snap = _state(tree, "ACDC/effres", "efficient_unet", "iter_3")
    assert state["step"] == 3
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    assert "resuming pretrain state from iter_2" in log
    assert log.count("loaded pretrained backbone") == 1


def test_train_arco_2d_loads_the_backbone(tree, monkeypatch):
    """The stage-2 CLI's models (unet, unet_stego) have no importer, as in
    JAX: the flag raises JAX's error; a loader that fills the model is
    called with the CLI's key and path, and student and teacher start from
    what it loaded."""
    argv = _argv(tree, "ACDC/arcopre", 0, "--pretrained_path", tree["pth"],
                 *SMALL_ARCO)
    with pytest.raises(ValueError,
                       match="no pretrained importer for model 'unet'"):
        train_arco_2d.main(argv)
    calls, filled = [], {}

    def fill(model, path, module):
        calls.append((model, path))
        with torch.no_grad():
            for i, (k, p) in enumerate(module.named_parameters()):
                p.fill_(0.01 * i)
                filled[k] = p.detach().clone()
        return sorted(filled)
    monkeypatch.setattr(train_arco_2d, "load_pretrained", fill)
    train_arco_2d.main(argv)
    assert calls == [("unet", tree["pth"])]
    state, _ = _state(tree, "ACDC/arcopre", "unet", "full_iter_0")
    for name in ("model", "ema_model"):
        for k, v in filled.items():
            assert torch.equal(state[name][k], v), f"{name}.{k}"


def test_train_arco_2d_does_not_load_after_resume(tree, monkeypatch):
    pretrain_2d.main(_argv(tree, "ACDC/stage1", 2) + SMALL_ISD)
    monkeypatch.setattr(train_arco_2d, "load_pretrained", _refuse)
    train_arco_2d.main(_argv(tree, "ACDC/stage2", 0, "--resume",
                             "ACDC/stage1", "--pretrained_path", tree["pth"],
                             *SMALL_ARCO))
    state, snap = _state(tree, "ACDC/stage2", "unet", "full_iter_0")
    stage1, _ = _state(tree, "ACDC/stage1", "unet", "iter_2")
    for k, v in stage1["model"].items():
        assert torch.equal(state["model"][k], v), k
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    assert "loading stage-1 checkpoint iter_2" in log
    assert "loaded pretrained backbone" not in log
