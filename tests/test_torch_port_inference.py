"""The port's serving API (arco_torch/inference.py) and Synapse/LiTS
evaluation CLI (arco_torch/cli/test_synapse.py) against JAX's.

``Segmenter`` and ``Segmenter3D`` (both ``device_eval`` modes) load port
checkpoints of seeded weights carried across from flax's shapes
(compat/from_flax.py) and must give exactly JAX's labels on the same
volumes. ``test_synapse`` mirrors tests/test_cli_eval_extra.py:29-67 (h5
volumes end to end, a missing checkpoint) and its JSON line must equal
JAX's test_synapse run on the same weights (equal labels give equal
metrics: rtol 1e-12). ``predict_volume_sharded`` is held in
tests/test_torch_port_parallel.py.
"""

import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu import inference as jinf
from arco_tpu.cli import test_synapse as jax_test_synapse
from arco_tpu.models import net_factory as jax_net_factory
from arco_tpu.models import net_factory_3d as jax_net_factory_3d
from arco_tpu.train import checkpoint as jckpt

from arco_torch.cli import test_synapse
from arco_torch.compat.from_flax import (unet_state_dict_from_flax,
                                         vnet_state_dict_from_flax)
from arco_torch.data.datasets import InMemoryVolumes
from arco_torch.inference import Segmenter, Segmenter3D
from arco_torch.models import net_factory, net_factory_3d
from arco_torch.train import checkpoint as ckpt
from test_torch_port_supervised import seeded_variables

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

PATCH_3D = (32, 32, 16)


def _port_checkpoint(snap, step, state_dict):
    ckpt._save(ckpt._path(str(snap), step),
               {"step": step, "model": state_dict})


@pytest.fixture(scope="module")
def unet(tmp_path_factory):
    """(JAX U-Net, params, stats, port snapshot dir with iter_3 and iter_7
    of those weights)."""
    jm = jax_net_factory("unet", in_chns=1, class_num=4)
    params, stats = seeded_variables(jm, (1, 32, 32, 1), seed=7)
    snap = tmp_path_factory.mktemp("unet") / "unet"
    sd = unet_state_dict_from_flax(params, stats)
    _port_checkpoint(snap, 7, sd)
    _port_checkpoint(snap, 3, {k: torch.zeros_like(v) for k, v in
                               sd.items()})
    return jm, params, stats, str(snap)


@pytest.fixture(scope="module")
def vnet(tmp_path_factory):
    jm = jax_net_factory_3d("vnet", in_chns=1, class_num=2)
    params, stats = seeded_variables(jm, (1,) + PATCH_3D + (1,), seed=8)
    snap = tmp_path_factory.mktemp("vnet") / "vnet"
    _port_checkpoint(snap, 4, vnet_state_dict_from_flax(params, stats))
    return jm, params, stats, str(snap)


def test_segmenter_matches_jax(unet):
    jm, params, stats, snap = unet
    vol = np.random.RandomState(0).rand(5, 40, 36).astype(np.float32)
    want = jinf.Segmenter(jm, params, stats, input_size=(32, 32),
                          slice_batch=2).predict_volume(vol)
    seg = Segmenter.from_snapshot(snap, input_size=(32, 32), slice_batch=2,
                                  device="cpu")
    got = seg.predict_volume(vol)
    assert got.shape == vol.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    slices = np.random.RandomState(1).rand(3, 32, 32).astype(np.float32)
    got_s = seg.predict_slices(slices)
    assert got_s.dtype == np.int32
    np.testing.assert_array_equal(
        got_s, np.asarray(jinf.Segmenter(jm, params, stats)
                          .predict_slices(slices)))


def test_from_snapshot_iteration(unet, tmp_path):
    """JAX's ``iteration or latest``: None and 0 read the newest (iter_7),
    3 reads iter_3 (zero weights: one label everywhere); no checkpoint is
    a FileNotFoundError."""
    *_, snap = unet
    vol = np.random.RandomState(2).rand(2, 32, 32).astype(np.float32)
    newest = Segmenter.from_snapshot(snap, input_size=(32, 32),
                                     device="cpu").predict_volume(vol)
    zero = Segmenter.from_snapshot(snap, input_size=(32, 32), iteration=0,
                                   device="cpu").predict_volume(vol)
    three = Segmenter.from_snapshot(snap, input_size=(32, 32), iteration=3,
                                    device="cpu").predict_volume(vol)
    np.testing.assert_array_equal(newest, zero)
    assert len(np.unique(three)) == 1 and len(np.unique(newest)) > 1
    with pytest.raises(FileNotFoundError):
        Segmenter.from_snapshot(str(tmp_path / "none"), device="cpu")
    with pytest.raises(FileNotFoundError):
        Segmenter3D.from_snapshot(str(tmp_path / "none"), device="cpu")


@pytest.mark.parametrize("device_eval", [True, False],
                         ids=["device_eval", "host"])
def test_segmenter3d_matches_jax(vnet, device_eval):
    jm, params, stats, snap = vnet
    vol = np.random.RandomState(3).rand(40, 36, 20).astype(np.float32)
    kw = dict(patch_size=PATCH_3D, stride_xy=18, stride_z=4,
              device_eval=device_eval)
    want = jinf.Segmenter3D(jm, params, stats, **kw).predict_volume(vol)
    got = Segmenter3D.from_snapshot(snap, device="cpu", **kw) \
        .predict_volume(vol)
    assert got.shape == vol.shape
    np.testing.assert_array_equal(got, np.asarray(want))


def _write_cases(root, rng, cases, shape=(3, 64, 64)):
    root.mkdir(parents=True, exist_ok=True)
    vols = {}
    for c in cases:
        image = rng.rand(*shape).astype(np.float32)
        label = rng.randint(0, 2, shape).astype(np.int64)
        with h5py.File(root / f"{c}.npy.h5", "w") as f:
            f["image"], f["label"] = image, label
        vols[c] = (image, label)
    return vols


@pytest.fixture(scope="module")
def synapse(tmp_path_factory):
    """An h5 Synapse tree (test_vol.txt: case0001, case0002;
    test_vol_40.txt: case0003) and one 2-class U-Net saved as a JAX and as
    a port checkpoint (iteration 10) of the same weights."""
    tmp = tmp_path_factory.mktemp("synapse")
    root = tmp / "Synapse"
    vols = _write_cases(root, np.random.RandomState(0),
                        ["case0001", "case0002", "case0003"])
    (root / "test_vol.txt").write_text("case0001\ncase0002\n")
    (root / "test_vol_40.txt").write_text("case0003\n")
    jm = jax_net_factory("unet", in_chns=1, class_num=2)
    params, stats = seeded_variables(jm, (1, 64, 64, 1), seed=9)
    jckpt.save_state(str(tmp / "jax" / "Synapse/smoke_5_labeledfinal" /
                         "unet"), 10,
                     {"params": {"model": params},
                      "batch_stats": {"model": stats}})
    _port_checkpoint(tmp / "port" / "Synapse/smoke_5_labeledfinal" / "unet",
                     10, unet_state_dict_from_flax(params, stats))
    return tmp, vols


def _argv(tmp, which, *extra):
    return ["--root_path", str(tmp / "Synapse"), "--exp", "Synapse/smoke",
            "--num_classes", "2", "--snapshot_dir", str(tmp / which),
            "--input_size", "64", "64", *extra]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("lits", ["0", "1"], ids=["synapse", "lits"])
def test_synapse_end_to_end_matches_jax(synapse, capsys, lits):
    tmp, _ = synapse
    result = test_synapse.main(_argv(tmp, "port", "--device", "cpu",
                                     "--lits", lits))
    got = _last_json(capsys)
    jax_test_synapse.main(_argv(tmp, "jax", "--lits", lits))
    want = _last_json(capsys)
    assert got["iteration"] == 10 and sorted(got) == sorted(want)
    assert 0.0 <= got["mean_dice"] <= 1.0
    assert np.asarray(result["mean"]).shape == (4,)
    assert result["raw"].shape[0] == (2 if lits == "0" else 1)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)


def test_synapse_in_memory_volumes(synapse, capsys):
    """``dataset=`` (what the card, which has no h5py, is handed) gives the
    h5 tree's line."""
    tmp, vols = synapse
    test_synapse.main(_argv(tmp, "port", "--device", "cpu"))
    want = _last_json(capsys)
    dataset = InMemoryVolumes([vols["case0001"], vols["case0002"]])
    test_synapse.main(_argv(tmp, "port", "--device", "cpu"),
                      dataset=dataset)
    assert _last_json(capsys) == want


def test_synapse_missing_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit):
        test_synapse.main(["--root_path", str(tmp_path), "--snapshot_dir",
                           str(tmp_path), "--device", "cpu"])


def test_synapse_defaults_follow_jax():
    got = vars(test_synapse.build_parser().parse_args([]))
    want = vars(jax_test_synapse.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want and got["num_classes"] == 8
