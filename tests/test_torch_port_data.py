"""Data, config, metrics and evaluation of the PyTorch port against the JAX
package (CPU).

Batches, index maps, labels and configs are compared exactly: the same
RandomState stream must give the same batches bit for bit. Host metrics are
the same numpy/scipy code and are compared exactly. ``evaluate_2d`` with the
same weights (the JAX UNet's carried across by compat/from_flax.py) is held
at rtol 1e-6 on the metrics: both argmax the same logits, which agree to
~1e-6, so the predicted labels and with them every metric match unless a
pixel's two top logits tie within that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu import config as jconfig
from arco_tpu.data import datasets as jdatasets
from arco_tpu.data import device_bank as jbank
from arco_tpu.data import pipeline as jpipeline
from arco_tpu.data import samplers as jsamplers
from arco_tpu.data import synthetic as jsynthetic
from arco_tpu.eval import slice2d as jslice2d
from arco_tpu.models.unet2d import UNet as JaxUNet
from arco_tpu.utils import metrics as jmetrics

from arco_torch import config
from arco_torch.compat.from_flax import unet_state_dict_from_flax
from arco_torch.data import datasets, device_bank, pipeline, samplers
from arco_torch.data import synthetic
from arco_torch.eval import slice2d
from arco_torch.models.unet2d import UNet
from arco_torch.utils import metrics

torch.set_num_threads(1)

ARGV = ["--root_path", "/data/ACDC", "--exp", "ACDC/x", "--labeled_num", "3",
        "--max_iterations", "123", "--patch_size", "128", "128", "--K", "8",
        "--arco.use_adv_morph", "false", "--deterministic", "0",
        "--arco.func", "asmc", "--T_s", "0.2", "--isd.combinations", "2",
        "--mesh_shape", "2", "4"]


# ---------------------------------------------------------------- config

def test_train_config_has_the_jax_fields_and_one_more():
    want = {f.name for f in dataclasses.fields(jconfig.TrainConfig)}
    got = {f.name for f in dataclasses.fields(config.TrainConfig)}
    assert got - want == {"device"} and not want - got
    assert config.TrainConfig().device == "cuda"
    for name in ("ISDConfig", "DataConfig", "OptimConfig", "ArcoConfig"):
        assert dataclasses.asdict(getattr(config, name)()) \
            == dataclasses.asdict(getattr(jconfig, name)()), name


@pytest.mark.parametrize("argv", [[], ARGV])
def test_parse_args(argv):
    want = dataclasses.asdict(jconfig.parse_args(argv))
    got = dataclasses.asdict(config.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want


def test_patients_to_slices():
    for ds, table in jconfig.PATIENTS_TO_SLICES.items():
        for n in table:
            assert config.patients_to_slices(ds, int(n)) \
                == jconfig.patients_to_slices(ds, int(n))
    assert config.PATIENTS_TO_SLICES == jconfig.PATIENTS_TO_SLICES
    with pytest.raises(ValueError):
        config.patients_to_slices("Unknown", 1)


# ------------------------------------------------------------ data sets

@pytest.fixture(scope="module")
def acdc(tmp_path_factory):
    """The same ACDC-layout tree written by both packages."""
    base = tmp_path_factory.mktemp("acdc")
    kw = dict(n_train=14, n_val=2, size=(40, 40), num_classes=3, depth=4,
              seed=0)
    jsynthetic.make_acdc_like(str(base / "jax"), **kw)
    synthetic.make_acdc_like(str(base / "port"), **kw)
    return str(base / "jax"), str(base / "port")


def test_make_acdc_like_writes_the_same_tree(acdc):
    jroot, proot = acdc
    jds = jdatasets.SliceDataset(jroot, "train")
    pds = datasets.SliceDataset(proot, "train")
    assert pds.sample_list == jds.sample_list
    for i in range(len(jds)):
        for a, b in zip(pds.load(i), jds.load(i)):
            np.testing.assert_array_equal(a, b)
    jval = jdatasets.SliceDataset(jroot, "val", list_name="test.list")
    pval = datasets.SliceDataset(proot, "val", list_name="test.list")
    for i in range(len(jval)):
        for a, b in zip(pval.load(i), jval.load(i)):
            np.testing.assert_array_equal(a, b)


def test_slice_dataset_get(acdc):
    jds = jdatasets.SliceDataset(acdc[0], "train", index=5, label_type=0,
                                 output_size=(32, 32))
    pds = datasets.SliceDataset(acdc[0], "train", index=5, label_type=0,
                                output_size=(32, 32))
    rj, rp = np.random.RandomState(3), np.random.RandomState(3)
    for i in list(range(len(jds))) * 3:
        want, got = jds.get(i, rj), pds.get(i, rp)
        for k in ("image", "label"):
            np.testing.assert_array_equal(got[k], want[k])


def test_synapse_dataset(tmp_path):
    root = synthetic.make_synapse_like(str(tmp_path / "syn"), n_train=6,
                                       size=(24, 24), num_classes=3)
    jds = jdatasets.SynapseDataset(root, root, "train", index=2,
                                   label_type=1, output_size=(16, 16))
    pds = datasets.SynapseDataset(root, root, "train", index=2,
                                  label_type=1, output_size=(16, 16))
    assert pds.sample_list == jds.sample_list and len(pds) == 2
    rj, rp = np.random.RandomState(1), np.random.RandomState(1)
    for i in [0, 1] * 4:
        want, got = jds.get(i, rj), pds.get(i, rp)
        for k in ("image", "label"):
            np.testing.assert_array_equal(got[k], want[k])


def test_samplers():
    js = jsamplers.TwoStreamBatchSampler(range(6), range(6, 20), 4, 2, 5)
    ps = samplers.TwoStreamBatchSampler(range(6), range(6, 20), 4, 2, 5)
    assert [list(map(int, b)) for b in ps] == [list(map(int, b)) for b in js]
    jr = jsamplers.replacement_batches(50, 3, seed=2)
    pr = samplers.replacement_batches(50, 3, seed=2)
    assert [next(pr) for _ in range(4)] == [next(jr) for _ in range(4)]


# --------------------------------------------------- batches and device bank

def _datasets(module, root, hw=32):
    return (module.SliceDataset(root, "train", index=5, label_type=1,
                                output_size=(hw, hw)),
            module.SliceDataset(root, "train", index=5, label_type=0,
                                output_size=(hw, hw)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_batch_streams_match_jax(acdc):
    """The first 3 batches of the host pipeline and of the device bank are
    JAX's, bit for bit (device images are NCHW, JAX's channels-last)."""
    jl, ju = _datasets(jdatasets, acdc[0])
    pl, pu = _datasets(datasets, acdc[0])
    jpipe = jpipeline.TwoStreamPipeline(jl, ju, 3, seed=9, labeled_bs=1)
    ppipe = pipeline.TwoStreamPipeline(pl, pu, 3, seed=9, labeled_bs=1)
    jgen = jbank.two_stream_device_batches(
        jbank.DeviceSliceBank.from_dataset(jl),
        jbank.DeviceSliceBank.from_dataset(ju), 1, 2, seed=9)
    pgen = device_bank.two_stream_device_batches(
        device_bank.DeviceSliceBank.from_dataset(pl, "cpu"),
        device_bank.DeviceSliceBank.from_dataset(pu, "cpu"), 1, 2, seed=9)
    try:
        for _ in range(3):
            want, got = next(jpipe), next(ppipe)
            for k in ("image_l", "label_l", "image_u", "label_u"):
                np.testing.assert_array_equal(got[k], want[k])
            dwant, dgot = next(jgen), next(pgen)
            np.testing.assert_array_equal(_nhwc(dgot["image_l"]),
                                          np.asarray(dwant["image_l"]))
            np.testing.assert_array_equal(_nhwc(dgot["image_u"]),
                                          np.asarray(dwant["image_u"]))
            np.testing.assert_array_equal(dgot["label_l"].numpy(),
                                          np.asarray(dwant["label_l"]))
            assert dgot["label_l"].dtype == torch.int32
            np.testing.assert_array_equal(dgot["image_l"][:, 0].numpy(),
                                          want["image_l"][..., 0])
    finally:
        jpipe.close()
        ppipe.close()


def test_transform_maps_match_numpy_and_scipy():
    """All 49 rows: identity, rot90(k) + flip(axis), and the rotations
    (scipy.ndimage.rotate, order 0, as random_generator_2d calls it)."""
    from scipy import ndimage
    rng = np.random.RandomState(0)
    for shape in ((9, 9), (16, 16), (33, 33)):
        x = rng.randint(1, 100, shape).astype(np.float32)
        maps, valid = device_bank.transform_maps(*shape)
        assert maps.shape == valid.shape == (49, shape[0] * shape[1])
        apply = lambda r: np.where(valid[r], x.ravel()[maps[r]],
                                   0.0).reshape(shape)
        np.testing.assert_array_equal(apply(0), x)
        for k in range(4):
            for axis in range(2):
                np.testing.assert_array_equal(
                    apply(1 + 2 * k + axis), np.flip(np.rot90(x, k), axis))
        for ai, ang in enumerate(device_bank.ROT_ANGLES):
            want = ndimage.rotate(x, int(ang), order=0, reshape=False)
            np.testing.assert_array_equal(apply(9 + ai), want,
                                          err_msg=str(ang))


def test_device_bank_gather_hits_every_mode(acdc):
    pl, _ = _datasets(datasets, acdc[0])
    bank = device_bank.DeviceSliceBank.from_dataset(pl, "cpu")
    jbank_l = jbank.DeviceSliceBank.from_dataset(_datasets(jdatasets,
                                                           acdc[0])[0])
    idxs = list(range(len(pl))) * 6
    params = bank.draw_params(np.random.RandomState(5), idxs)
    np.testing.assert_array_equal(
        params, jbank_l.draw_params(np.random.RandomState(5), idxs))
    assert set(params[:, 1].tolist()) == {0, 1, 2}
    img, lab = bank.gather(params)
    jimg, jlab = jbank_l.gather(params)
    np.testing.assert_array_equal(_nhwc(img), np.asarray(jimg))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))


def test_device_bank_refuses_non_square_slices():
    with pytest.raises(ValueError, match="square"):
        device_bank.DeviceSliceBank(np.zeros((2, 8, 6), np.float32),
                                    np.zeros((2, 8, 6), np.int8), "cpu")


def test_prefetcher_to_cpu():
    batches = [{"a": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = [b["a"] for b in pipeline.Prefetcher(iter(batches), "cpu")]
    assert [int(t[0, 0]) for t in got] == list(range(5))
    assert all(isinstance(t, torch.Tensor) for t in got)


# -------------------------------------------------------------- metrics

def test_host_metrics():
    rs = np.random.RandomState(4)
    for _ in range(3):
        pred = rs.rand(4, 20, 20) > 0.6
        gt = rs.rand(4, 20, 20) > 0.5
        for name in ("dc", "jc", "hd95", "asd"):
            assert getattr(metrics, name)(pred, gt) \
                == getattr(jmetrics, name)(pred, gt), name
        assert metrics.calculate_metric_percase(pred, gt, (1.0, 2.0, 1.5)) \
            == jmetrics.calculate_metric_percase(pred, gt, (1.0, 2.0, 1.5))
    empty = np.zeros((5, 5), bool)
    assert metrics.calculate_metric_percase(empty, gt[0, :5, :5]) \
        == (0.0, 0.0, 0.0, 0.0)


def test_dice_coefficient():
    rs = np.random.RandomState(5)
    a = rs.rand(2, 8, 8, 3).astype(np.float32)
    b = (rs.rand(2, 8, 8, 3) > 0.5).astype(np.float32)
    want = np.asarray(jmetrics.dice_coefficient(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = metrics.dice_coefficient(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ------------------------------------------------------------ evaluation

def test_evaluate_2d_with_jax_weights(acdc):
    """The JAX UNet's weights (BatchNorm statistics moved off their init by
    one train-mode forward) evaluated by both packages on the same
    volumes, zoomed 40 -> 32 and back."""
    nc, hw = 3, 32
    jmodel = JaxUNet(in_chns=1, class_num=nc)
    x = jnp.asarray(np.random.RandomState(6).rand(4, hw, hw, 1),
                    jnp.float32)
    variables = jmodel.init({"params": jax.random.PRNGKey(1),
                             "dropout": jax.random.PRNGKey(2)}, x,
                            train=False)
    _, mutated = jmodel.apply(variables, x, train=True,
                              rngs={"dropout": jax.random.PRNGKey(3)},
                              mutable=["batch_stats"])
    params, stats = variables["params"], mutated["batch_stats"]

    @jax.jit
    def jpredict(x):
        logits, _, _ = jmodel.apply({"params": params, "batch_stats": stats},
                                    x, train=False)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    val = jdatasets.SliceDataset(acdc[0], "val", list_name="val.list")
    load = lambda c: val.load(val.sample_list.index(c))
    want = jslice2d.evaluate_2d(val.sample_list, load, jpredict, nc,
                                input_size=(hw, hw))

    model = UNet(in_chns=1, class_num=nc)
    model.load_state_dict(unet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats)))
    got = slice2d.evaluate_2d(val.sample_list, load,
                              slice2d.model_predictor(model, "cpu"), nc,
                              input_size=(hw, hw))
    assert want["raw"].shape == got["raw"].shape == (2, nc - 1, 4)
    assert (want["raw"][..., 0] > 0).any()
    for k in ("per_class", "mean", "raw"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
