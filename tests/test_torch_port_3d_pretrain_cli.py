"""The port's 3D stage-1 CLI (``pretrain_3d``), its checkpoints and the
handoff into ``train_arco_3d --resume``, on the CPU at 32x32x16 patches of a
synthetic LA tree (48x48x32 h5 volumes) and of in-memory volumes.

- ``pretrain_3d`` trains 3 steps and checkpoints every 2; a rerun to 5
  resumes from iter_3. The snapshot directory is ``{exp}_{labeled_num}
  _labeled{suffix}/{model}`` as in JAX, and ``default_3d_config`` is JAX's
  field for field.
- Its batches equal the ones arco_tpu/cli/pretrain_3d.py draws from the
  same tree and seed (its sampler, RandomState and volume bank, or its
  host path), exactly; volumes of unequal shapes fall back to the host
  path, and the log says so.
- 3 V-Net steps + save + restore + 2 steps equal 5 straight steps bit for
  bit (one thread; V-Net dropout on, drawn from the state's generator).
- ``train_arco_3d --resume`` starts student and teacher from the
  pretrain's newest iter_<N> V-Net, bit for bit.
- ``--model unet_3D`` and ``attention_unet`` pretrain and evaluate through
  ``test_3d``; ``--train_encoder`` / ``--train_decoder`` freeze a V-Net
  half and are refused for the 3-D U-Nets.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from arco_tpu.cli.pretrain_3d import default_3d_config as jax_default
from arco_tpu.data import datasets as jdatasets
from arco_tpu.data import samplers as jsamplers
from arco_tpu.data.device_bank import DeviceVolumeBank as JaxDeviceVolumeBank

from arco_torch.cli import pretrain_3d, test_3d, train_arco_3d
from arco_torch.config import ISDConfig, OptimConfig
from arco_torch.data.datasets import InMemoryVolumes, LAHeartDataset
from arco_torch.data.synthetic import la_volume, make_la_like
from arco_torch.models import net_factory_3d
from arco_torch.train import checkpoint as ckpt
from arco_torch.train import freeze, pretrain

torch.set_num_threads(1)

PATCH, SEED = ("32", "32", "16"), 7
SMALL_ISD = ["--isd.K", "4", "--isd.latent_feature_size", "32",
             "--isd.output_pooling_size", "4", "--isd.patch_size", "16"]
SMALL_ARCO = ["--arco.K", "2", "--arco.num_queries", "16",
              "--arco.num_negatives", "8", "--arco.memobank_size", "128",
              "--arco.memobank_size_bg", "128", "--arco.memobank_enqueue",
              "32", "--arco.topk", "2"]


def _argv(root, model_dir, exp, iterations, *extra):
    return ["--root_path", root, "--exp", exp, "--labeled_num", "2",
            "--device", "cpu", "--patch_size", *PATCH, "--batch_size", "2",
            "--labeled_bs", "1", "--snapshot_dir", model_dir,
            "--compute_dtype", "float32", "--seed", str(SEED),
            "--log_every", "1", "--ckpt_every", "2", "--max_iterations",
            str(iterations)] + SMALL_ISD + list(extra)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    base = tmp_path_factory.mktemp("pretrain3d_cli")
    root = make_la_like(str(base / "LA"), n_train=6, size=(48, 48, 32))
    model_dir = str(base / "model")
    pretrain_3d.main(_argv(root, model_dir, "LA/pre", 3))
    pretrain_3d.main(_argv(root, model_dir, "LA/pre", 5))
    snap = os.path.join(model_dir, "LA/pre_2_labeledfinal", "vnet")
    return {"root": root, "model_dir": model_dir, "snap": snap}


def test_pretrain_3d_trains_checkpoints_and_resumes(pretrained):
    snap = pretrained["snap"]
    assert {"iter_2", "iter_3", "iter_4", "iter_5"} <= set(os.listdir(snap))
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    for want in ("device data path: 6 volumes staged on cpu",
                 "resuming pretrain state from iter_3",
                 "iteration 5 : loss", "vol/s"):
        assert want in log
    rows = [json.loads(ln) for ln in open(os.path.join(snap,
                                                       "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["loss"]) and r["volumes_per_sec"] > 0
               for r in rows)
    tree = torch.load(os.path.join(snap, "iter_5", "state.pt"),
                      weights_only=True)
    # 5 steps x 2 keys in a queue of 4; 3 x 3 x 1 patches of 2 x 4^3
    assert tree["step"] == 5
    assert tree["queue_ptr"] == tree["mask_queue_ptr"] == 2
    assert tree["queue"].shape == (4, 32)
    assert tree["queue_mask"].shape == (4, 9, 2 * 4 ** 3)
    assert tree["optimizer"]["param_groups"][0]["nesterov"] is False
    # the latent head reads the V-Net's 128-channel latent, 256 wide
    assert tree["latent_head"]["0.weight"].shape == (256, 128)
    assert all(torch.isfinite(v.float()).all()
               for v in tree["model"].values())


def test_default_3d_config_is_jaxs():
    got, want = pretrain_3d.default_3d_config(), jax_default()
    for part in ("data", "optim", "isd", "arco"):
        for f in dataclasses.fields(getattr(want, part)):
            assert getattr(getattr(got, part), f.name) == getattr(
                getattr(want, part), f.name), f"{part}.{f.name}"
    assert (got.model, got.seed) == (want.model, want.seed) == ("vnet",
                                                                1337)
    assert got.data.patch_size == (112, 112, 80)
    assert got.isd.patch_size == 20 and got.optim.nesterov is False


@pytest.mark.parametrize("enc,dec,suffix", [
    (True, True, "final"), (True, False, "_train_encoder"),
    (False, True, "_train_decoder")])
def test_snapshot_directory(enc, dec, suffix):
    """{snapshot_dir}/{exp}_{labeled_num}_labeled{suffix}/{model}
    (arco_tpu/cli/pretrain_3d.py:153-158)."""
    cfg, snap = pretrain_3d.parse([
        "--exp", "LA/x", "--labeled_num", "8", "--snapshot_dir", "m",
        "--train_encoder", str(enc), "--train_decoder", str(dec)])
    assert snap == os.path.join("m", f"LA/x_8_labeled{suffix}", "vnet")
    assert freeze.snapshot_suffix(enc, dec) == suffix


# ----------------------------------------------------------------- batches

def _jax_batches(root, device_data):
    """arco_tpu/cli/pretrain_3d.py:95-134, epoch after epoch."""
    patch = tuple(int(p) for p in PATCH)
    ds = jdatasets.LAHeartDataset(root, "train", patch_size=patch)
    sampler = jsamplers.TwoStreamBatchSampler(
        [0, 1], list(range(2, len(ds))), 2, 1, seed=SEED)
    host_rng = np.random.RandomState(SEED)
    bank = JaxDeviceVolumeBank.from_dataset(ds, patch) if device_data \
        else None
    while True:
        for idxs in sampler:
            if bank is not None:
                images, labels = bank.gather(bank.draw_params(host_rng,
                                                              idxs))
            else:
                samples = [ds.get(i, host_rng) for i in idxs]
                images = np.stack([s["image"] for s in samples])
                labels = np.stack([s["label"] for s in samples])
            yield np.asarray(images), np.asarray(labels)


@pytest.mark.parametrize("device_data", [True, False])
def test_pretrain_batches_match_the_jax_cli(pretrained, device_data):
    cfg, _ = pretrain_3d.parse(_argv(pretrained["root"], "", "LA/pre", 5))
    cfg.data.device_data = device_data
    port = pretrain_3d.pretrain_batches(
        cfg, LAHeartDataset(cfg.data.root_path, "train",
                            patch_size=cfg.data.patch_size), "cpu")
    want = _jax_batches(pretrained["root"], device_data)
    # 2 batches make an epoch of the labeled stream: cross into the third
    for _ in range(5):
        images, labels = next(port)
        w_images, w_labels = next(want)
        np.testing.assert_array_equal(images.movedim(1, -1).numpy(),
                                      w_images)
        np.testing.assert_array_equal(labels.numpy(), w_labels)


def test_unequal_volumes_take_the_host_path_and_say_so(tmp_path):
    rs = np.random.RandomState(0)
    vols = [la_volume(rs, (40, 40, 24)), la_volume(rs, (40, 40, 24)),
            la_volume(rs, (44, 44, 24))]
    cfg, snap = pretrain_3d.parse(_argv("", str(tmp_path), "LA/host", 1))
    pretrain_3d.train(cfg, snap, dataset=InMemoryVolumes(vols, (32, 32, 16)))
    with open(os.path.join(snap, "log.txt")) as f:
        lines = [ln for ln in f if "data path" in ln]
    assert len(lines) == 1
    assert "device data path unavailable" in lines[0]
    assert "the host pipeline feeds cpu" in lines[0]
    assert ckpt.latest_step(snap) == 1


# ------------------------------------------------------ state checkpoints

B, S = 2, (32, 32, 16)


def _state(seed=0):
    """A small port PretrainState with the V-Net's dropout on."""
    cfg = ISDConfig(K=4, latent_feature_size=32, output_pooling_size=4,
                    patch_size=16)
    torch.manual_seed(seed)
    mods = pretrain.make_isd_modules(net_factory_3d("vnet", class_num=2), 2,
                                     latent_feature_size=32,
                                     output_pooling_size=4)
    optim = OptimConfig(nesterov=False)
    state = pretrain.init_pretrain_state(mods, cfg, (B, 1) + S, optim,
                                         seed=seed, device="cpu",
                                         compute_dtype=torch.float32)
    step = pretrain.make_pretrain_step(cfg, 1, 2, 100, optim, device="cpu")
    return state, step


def _batches(n):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        label = rs.randint(0, 2, (B,) + S).astype(np.int32)
        image = torch.from_numpy(label[:, None].astype(np.float32)
                                 + 0.2 * rs.randn(B, 1, *S)
                                 .astype(np.float32))
        out.append({"student_image": image, "teacher_image": image,
                    "label": torch.from_numpy(label)})
    return out


def test_resumed_3d_pretrain_equals_a_straight_one(tmp_path):
    batches = _batches(5)
    straight, step = _state()
    for batch in batches:
        step(straight, batch)
    first, step = _state()
    for batch in batches[:3]:
        step(first, batch)
    ckpt.save_state(str(tmp_path), 3, first)
    resumed, step = _state(seed=5)
    ckpt.restore_state(str(tmp_path), 3, resumed)
    for batch in batches[3:]:
        step(resumed, batch)
    for name in ckpt._PRETRAIN_MODULES:
        sa = getattr(straight, name).state_dict()
        sb = getattr(resumed, name).state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"
    assert torch.equal(straight.queue_mask, resumed.queue_mask)
    assert torch.equal(straight.queue, resumed.queue)
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())


# ----------------------------------------------------------------- handoff

def test_stage2_resume_starts_from_the_pretrain_vnet(pretrained,
                                                     monkeypatch):
    seen = {}
    make_step = train_arco_3d.make_arco_step

    def recording_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def first_step_records(state, batch, draws=None):
            if not seen:
                for name in ("model", "ema_model"):
                    seen[name] = {k: v.clone() for k, v in
                                  getattr(state, name).state_dict().items()}
            return step(state, batch, draws)
        return first_step_records

    monkeypatch.setattr(train_arco_3d, "make_arco_step", recording_make_step)
    train_arco_3d.main(_argv(pretrained["root"], pretrained["model_dir"],
                             "LA/arco", 2, "--resume", "LA/pre",
                             "--batch_size", "4", "--labeled_bs", "2")
                       + SMALL_ARCO)
    snap = os.path.join(pretrained["model_dir"], "LA/arco_2_labeledfinal",
                        "vnet")
    with open(os.path.join(snap, "log.txt")) as f:
        assert "loading stage-1 checkpoint iter_5" in f.read()
    want = ckpt.load_model_params(pretrained["snap"], 5)
    for name in ("model", "ema_model"):
        assert seen[name].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(seen[name][k], v), f"{name}.{k}"
    # the running statistics are the pretrain's, not a fresh init's
    assert not torch.equal(want["block_one.conv.1.running_var"],
                           torch.ones(16))
    assert ckpt.latest_step(snap) == 2


# -------------------------------------------------- the 3-D U-Nets, freeze

@pytest.mark.parametrize("model", ["unet_3D", "attention_unet"])
def test_unet3d_models_pretrain_and_evaluate(pretrained, model, capsys):
    pretrain_3d.main(_argv(pretrained["root"], pretrained["model_dir"],
                           "LA/u3d", 2, "--model", model))
    snap = os.path.join(pretrained["model_dir"], "LA/u3d_2_labeledfinal",
                        model)
    rows = [json.loads(ln) for ln in open(os.path.join(snap,
                                                       "metrics.jsonl"))]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    tree = torch.load(os.path.join(snap, "iter_2", "state.pt"),
                      weights_only=True)
    # UNet3D's latent is its 256-channel center
    assert tree["latent_head"]["0.weight"].shape == (256, 256)
    res = test_3d.main(["--root_path", pretrained["root"], "--exp", "LA/u3d",
                        "--labeled_num", "2", "--snapshot_dir",
                        pretrained["model_dir"], "--patch_size", *PATCH,
                        "--device", "cpu", "--model", model])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["iteration"] == 2
    assert np.isfinite(res["raw"]).all()
    assert 0.0 <= line["mean_dice"] <= 1.0


@pytest.mark.parametrize("enc,dec,suffix", [
    (True, False, "_train_encoder"), (False, True, "_train_decoder")])
def test_freeze_flags_freeze_a_vnet_half(pretrained, enc, dec, suffix):
    pretrain_3d.main(_argv(pretrained["root"], pretrained["model_dir"],
                           "LA/frz", 1, "--train_encoder", str(enc),
                           "--train_decoder", str(dec)))
    snap = os.path.join(pretrained["model_dir"], f"LA/frz_2_labeled{suffix}",
                        "vnet")
    tree = torch.load(os.path.join(snap, "iter_1", "state.pt"),
                      weights_only=True)
    model = net_factory_3d("vnet", class_num=2)
    labels = freeze.model_param_labels(model, enc, dec)
    n_frozen = sum(v == "freeze" for v in labels.values())
    assert 0 < n_frozen < len(labels)
    start, _ = _state(seed=SEED)       # only the parameter counts are read
    n_heads = sum(len(list(getattr(start, n).parameters())) for n in
                  ("latent_head", "latent_predictor", "outputs_head",
                   "outputs_predictor"))
    assert len(tree["optimizer"]["state"]) == \
        len(labels) - n_frozen + n_heads


def test_unet3d_refuses_the_freeze_flags(pretrained, tmp_path):
    with pytest.raises(ValueError, match="encoder/decoder"):
        pretrain_3d.main(_argv(pretrained["root"], str(tmp_path), "LA/no",
                               1, "--model", "unet_3D", "--train_decoder",
                               "False"))
