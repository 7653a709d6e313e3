"""Round trips of the port's serving export (arco_torch/export.py), case for
case as tests/test_export.py holds arco_tpu/export.py: the U-Net exported
with ``torch.export``, saved, loaded with ``load_predictor`` (torch only)
and run, static and batch-dynamic, every output head, a bad batch mode,
the dtype in the calling convention, a readable shape error and the V-Net
with a dynamic batch. In place of JAX's multi-platform lowering, an
artifact is loaded onto a named device through ``move_to_device_pass``.
Then the CLI end to end.

Each loaded artifact is held against the port's eager forward exactly,
and the eager forward against JAX's ``export.make_predict_fn`` on the same
seeded weights carried across (compat/from_flax.py): labels equal, softmax
within 1e-5, logits within 1e-4 (f32 convolutions in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu import export as jexport
from arco_tpu.models import net_factory as jax_net_factory
from arco_tpu.models import net_factory_3d as jax_net_factory_3d

from arco_torch.cli import export_model
from arco_torch.compat.from_flax import (unet_state_dict_from_flax,
                                         vnet_state_dict_from_flax)
from arco_torch.export import (export_predictor, input_spec, load_predictor,
                               make_predict_fn, save_predictor)
from arco_torch.models import net_factory, net_factory_3d
from arco_torch.train import checkpoint as ckpt
from test_torch_port_supervised import seeded_variables

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

SIZE = 32  # spatial size: enough to exercise all 4 U-Net down/up stages


@pytest.fixture(scope="module")
def pair():
    """(port U-Net, JAX U-Net, JAX variables) with the same weights."""
    jm = jax_net_factory("unet", in_chns=1, class_num=4)
    params, stats = seeded_variables(jm, (1, SIZE, SIZE, 1), seed=4)
    model = net_factory("unet", in_chns=1, class_num=4)
    model.load_state_dict(unet_state_dict_from_flax(params, stats))
    return model, jm, {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def static_path(pair, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "unet.pt2")
    save_predictor(path, export_predictor(pair[0], (2, 1, SIZE, SIZE),
                                          device="cpu"))
    return path


def _input(batch, seed=0):
    return np.random.RandomState(seed).randn(batch, 1, SIZE, SIZE) \
        .astype(np.float32)


def _jax(pair, x, output="argmax", dtype=jnp.float32):
    _, jm, variables = pair
    fn = jax.jit(jexport.make_predict_fn(jm, variables, output, dtype))
    out = np.asarray(fn(jnp.asarray(np.moveaxis(x, 1, -1))))
    return out if output == "argmax" else np.moveaxis(out, -1, 1)


def test_static_roundtrip(pair, static_path):
    x = _input(2)
    got = load_predictor(static_path)(x)
    want = make_predict_fn(pair[0])(torch.from_numpy(x))
    assert got.shape == (2, SIZE, SIZE) and got.dtype == torch.int32
    assert torch.equal(got, want)
    np.testing.assert_array_equal(want.numpy(), _jax(pair, x))


def test_dynamic_batch(pair, tmp_path):
    """Exported from an input shape of batch 1 (traced at 2) and served at
    batch 1 and 3."""
    ep = export_predictor(pair[0], (1, 1, SIZE, SIZE), batch="dynamic",
                          device="cpu")
    assert not isinstance(input_spec(ep)[0][0], int)
    path = str(tmp_path / "unet_dyn.pt2")
    save_predictor(path, ep)
    predict = load_predictor(path)
    ref = make_predict_fn(pair[0])
    for b in (1, 3):
        x = _input(b, seed=b)
        got = predict(x)
        assert got.shape == (b, SIZE, SIZE)
        assert torch.equal(got, ref(torch.from_numpy(x)))
        np.testing.assert_array_equal(got.numpy(), _jax(pair, x))


def test_output_modes(pair, tmp_path):
    x = torch.from_numpy(_input(1))
    logits = make_predict_fn(pair[0], "logits")(x)
    soft = make_predict_fn(pair[0], "softmax")(x)
    assert logits.shape == (1, 4, SIZE, SIZE) and logits.dtype == \
        torch.float32
    torch.testing.assert_close(soft.sum(1), torch.ones(1, SIZE, SIZE),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(soft, torch.softmax(logits, 1), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(soft.numpy(), _jax(pair, x.numpy(),
                                                  "softmax"), atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), _jax(pair, x.numpy(),
                                                    "logits"), atol=1e-4)
    path = str(tmp_path / "unet_soft.pt2")
    save_predictor(path, export_predictor(pair[0], (1, 1, SIZE, SIZE),
                                          output="softmax", device="cpu"))
    assert torch.equal(load_predictor(path)(x), soft)
    with pytest.raises(ValueError):
        make_predict_fn(pair[0], "nope")


def test_bad_batch_mode(pair):
    with pytest.raises(ValueError):
        export_predictor(pair[0], (1, 1, SIZE, SIZE), batch="sometimes",
                         device="cpu")


def test_load_onto_a_named_device(pair, static_path):
    """The port's counterpart of test_multiplatform_lowering: one artifact
    served on the device the caller names (move_to_device_pass); here the
    CPU (the card in tests/test_torch_port_cuda.py)."""
    predict = load_predictor(static_path, device="cpu")
    x = _input(2, seed=5)
    got = predict(x)
    assert all(t.device.type == "cpu"
               for t in predict.exported.state_dict.values())
    assert torch.equal(got, make_predict_fn(pair[0])(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy(), _jax(pair, x))


def test_dtype_in_calling_convention(pair, tmp_path):
    """dtype=bfloat16 must produce a genuinely bf16-in artifact, and
    load_predictor must cast the caller's input to the exported dtype."""
    ep = export_predictor(pair[0], (1, 1, SIZE, SIZE), dtype=torch.bfloat16,
                          device="cpu")
    assert input_spec(ep)[1] == torch.bfloat16
    path = str(tmp_path / "unet_bf16.pt2")
    save_predictor(path, ep)
    x = _input(1)
    got = load_predictor(path)(x)
    assert got.shape == (1, SIZE, SIZE)
    assert torch.equal(got, make_predict_fn(pair[0], dtype=torch.bfloat16)(
        torch.from_numpy(x)))
    np.testing.assert_array_equal(
        got.numpy(), _jax(pair, x, dtype=jnp.bfloat16))


def test_shape_mismatch_is_readable(static_path):
    """A mis-shaped input must fail with a readable ValueError naming both
    shapes, not the program's own guard error."""
    predict = load_predictor(static_path)
    with pytest.raises(ValueError, match="does not match the exported"):
        predict(_input(3))  # wrong batch
    with pytest.raises(ValueError, match="does not match the exported"):
        predict(_input(2)[:, 0])  # wrong rank


def test_vnet3d_dynamic_roundtrip(tmp_path):
    """3D flagship (V-Net, [B, C, X, Y, Z] in the port) with a symbolic
    batch."""
    jm = jax_net_factory_3d("vnet", in_chns=1, class_num=2)
    params, stats = seeded_variables(jm, (1, SIZE, SIZE, 16, 1), seed=6)
    model = net_factory_3d("vnet", in_chns=1, class_num=2)
    model.load_state_dict(vnet_state_dict_from_flax(params, stats))
    path = str(tmp_path / "vnet.pt2")
    save_predictor(path, export_predictor(model, (1, 1, SIZE, SIZE, 16),
                                          batch="dynamic", device="cpu"))
    x = np.random.RandomState(2).randn(2, 1, SIZE, SIZE, 16) \
        .astype(np.float32)
    got = load_predictor(path)(x)
    assert got.shape == (2, SIZE, SIZE, 16)
    assert torch.equal(got, make_predict_fn(model)(torch.from_numpy(x)))
    want = jax.jit(jexport.make_predict_fn(
        jm, {"params": params, "batch_stats": stats}))(
        jnp.asarray(np.moveaxis(x, 1, -1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cli_end_to_end(pair, tmp_path, capsys):
    """export_model from a port checkpoint: the summary line, and the
    artifact's labels equal the eager model's at batch 1 and 3."""
    snap = tmp_path / "model" / "ACDC/x_7_labeledfinal" / "unet"
    ckpt._save(ckpt._path(str(snap), 5),
               {"step": 5, "model": pair[0].state_dict()})
    out = str(tmp_path / "cli.pt2")
    export_model.main(["--exp", "ACDC/x", "--snapshot_dir",
                       str(tmp_path / "model"), "--input_size", str(SIZE),
                       str(SIZE), "--batch", "dynamic", "--out", out,
                       "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"exported iter_5 -> {out} (")
    assert "device=cpu" in line and "in=['float32[" in line
    assert os.path.getsize(out) > 0
    predict = load_predictor(out)
    for b in (1, 3):
        x = _input(b, seed=10 + b)
        assert torch.equal(predict(x),
                           make_predict_fn(pair[0])(torch.from_numpy(x)))
    with pytest.raises(SystemExit):
        export_model.main(["--exp", "ACDC/none", "--snapshot_dir",
                           str(tmp_path / "model"), "--out", out,
                           "--device", "cpu"])
    with pytest.raises(SystemExit):
        export_model.main(["--exp", "ACDC/x", "--snapshot_dir",
                           str(tmp_path / "model"), "--dims", "3",
                           "--out", out, "--device", "cpu"])
