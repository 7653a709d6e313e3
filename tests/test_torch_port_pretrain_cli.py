"""The port's stage-1 CLI, its checkpoints and the handoff into stage 2, on
the CPU at 32x32 on a synthetic ACDC tree (the sizes of
tests/test_cli_pipeline.py).

- ``pretrain_2d`` trains 3 steps and checkpoints; a rerun to 6 resumes
  from iter_3. A restored PretrainState equals the saved one bit for bit,
  and 3 steps + save + restore + 3 steps equal 6 straight steps bit for
  bit (one thread; U-Net dropout on, drawn from the state's generator).
- The CLI's batches equal the ones arco_tpu/cli/pretrain_2d.py draws from
  the same seed (its sampler, RandomState and slice bank, or its host
  path), exactly.
- ``train_arco_2d --resume`` starts student and teacher from the
  pretrain's newest iter_<N> weights and BatchNorm statistics, bit for
  bit.
- The freeze flags pick the snapshot directory as ``snapshot_suffix``
  says, and freeze the half they name.
"""

import os

import numpy as np
import pytest
import torch

from arco_tpu.data import datasets as jdatasets
from arco_tpu.data import samplers as jsamplers
from arco_tpu.data.device_bank import DeviceSliceBank as JaxDeviceSliceBank
from arco_tpu.train import freeze as jfreeze

from arco_torch.cli import pretrain_2d, train_arco_2d
from arco_torch.config import ISDConfig, OptimConfig, parse_args
from arco_torch.data.datasets import SliceDataset
from arco_torch.data.synthetic import make_acdc_like
from arco_torch.models import net_factory
from arco_torch.train import checkpoint as ckpt
from arco_torch.train import freeze, pretrain

torch.set_num_threads(1)

HW, NC, SEED = 32, 3, 7
SMALL_ISD = ["--isd.K", "2", "--isd.latent_feature_size", "32",
             "--isd.output_pooling_size", "4", "--isd.patch_size", "16"]
SMALL_ARCO = ["--arco.K", "2", "--arco.num_queries", "16",
              "--arco.num_negatives", "8", "--arco.memobank_size", "64",
              "--arco.memobank_size_bg", "64", "--arco.memobank_enqueue",
              "16", "--arco.topk", "2"]


def _argv(data, model_dir, exp, iterations, *extra):
    return ["--root_path", data, "--exp", exp, "--labeled_num", "1",
            "--device", "cpu", "--patch_size", str(HW), str(HW),
            "--num_classes", str(NC), "--batch_size", "2", "--labeled_bs",
            "1", "--snapshot_dir", model_dir, "--compute_dtype", "float32",
            "--seed", str(SEED), "--log_every", "1", "--ckpt_every", "2",
            "--max_iterations", str(iterations)] + SMALL_ISD + list(extra)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    base = tmp_path_factory.mktemp("pretrain_cli")
    data = make_acdc_like(str(base / "ACDC"), n_train=30, n_val=1,
                          size=(HW, HW), num_classes=NC)
    model_dir = str(base / "model")
    pretrain_2d.main(_argv(data, model_dir, "ACDC/pre", 3))
    pretrain_2d.main(_argv(data, model_dir, "ACDC/pre", 6))
    snap = os.path.join(model_dir, "ACDC/pre_1_labeledfinal", "unet")
    return {"data": data, "model_dir": model_dir, "snap": snap}


def test_pretrain_cli_trains_checkpoints_and_resumes(pretrained):
    snap = pretrained["snap"]
    assert {"iter_2", "iter_3", "iter_4", "iter_6"} <= set(os.listdir(snap))
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    assert "resuming pretrain state from iter_3" in log
    assert "device data path: 30 slices staged on cpu" in log
    assert "iteration 6 : loss" in log
    tree = torch.load(os.path.join(snap, "iter_6", "state.pt"),
                      weights_only=True)
    # 6 steps x 2 keys in a queue of 2
    assert tree["step"] == 6
    assert tree["queue_ptr"] == tree["mask_queue_ptr"] == 0
    assert tree["queue"].shape == (2, 32)
    assert tree["queue_mask"].shape == (2, 9, NC * 16)
    # the optimizer is plain SGD momentum, no nesterov (pretrain_2D.py:196)
    assert tree["optimizer"]["param_groups"][0]["nesterov"] is False
    for part in ("model", "ema_model"):
        assert all(torch.isfinite(v.float()).all()
                   for v in tree[part].values())


# ------------------------------------------------------ state checkpoints

B = 2


def _state(seed=0):
    """A small port PretrainState with the U-Net's dropout on."""
    cfg = ISDConfig(K=4, latent_feature_size=32, output_pooling_size=4,
                    patch_size=16)
    torch.manual_seed(seed)
    mods = pretrain.make_isd_modules(net_factory("unet", class_num=NC), NC,
                                     latent_feature_size=32,
                                     output_pooling_size=4)
    optim = OptimConfig(nesterov=False)
    state = pretrain.init_pretrain_state(mods, cfg, (B, 1, HW, HW), optim,
                                         seed=seed, device="cpu",
                                         compute_dtype=torch.float32)
    step = pretrain.make_pretrain_step(cfg, 1, NC, 100, optim, device="cpu")
    return state, step


def _batches(n):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        label = rs.randint(0, NC, (B, HW, HW)).astype(np.int32)
        image = torch.from_numpy(label[:, None].astype(np.float32) / 2
                                 + 0.1 * rs.randn(B, 1, HW, HW)
                                 .astype(np.float32))
        out.append({"student_image": image, "teacher_image": image + 0.05,
                    "label": torch.from_numpy(label)})
    return out


def _assert_same_state(a, b):
    for name in ckpt._PRETRAIN_MODULES:
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for k in oa["state"]:
        assert torch.equal(oa["state"][k]["momentum_buffer"],
                           ob["state"][k]["momentum_buffer"])
    assert torch.equal(a.queue, b.queue)
    assert torch.equal(a.queue_mask, b.queue_mask)
    assert (a.queue_ptr, a.mask_queue_ptr, a.step) \
        == (b.queue_ptr, b.mask_queue_ptr, b.step)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_restored_state_equals_the_saved_one(tmp_path):
    state, step = _state()
    for batch in _batches(3):
        step(state, batch)
    ckpt.save_state(str(tmp_path), state.step, state)
    fresh, _ = _state(seed=5)
    assert not torch.equal(fresh.queue, state.queue)
    ckpt.restore_state(str(tmp_path), 3, fresh)
    _assert_same_state(state, fresh)
    assert ckpt.latest_step(str(tmp_path)) == 3
    # stage 2 reads the student U-Net from the same file
    params = ckpt.load_model_params(str(tmp_path), 3)
    for k, v in state.model.state_dict().items():
        assert torch.equal(params[k], v)


def test_resumed_pretrain_equals_a_straight_one(tmp_path):
    batches = _batches(6)
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
    _assert_same_state(straight, resumed)


# ----------------------------------------------------------------- batches

@pytest.mark.parametrize("device_data", [True, False])
def test_pretrain_batches_match_the_jax_cli(pretrained, device_data):
    cfg = parse_args(_argv(pretrained["data"], "", "ACDC/pre", 6))
    cfg.data.device_data = device_data
    port = pretrain_2d.pretrain_batches(
        cfg, SliceDataset(cfg.data.root_path, "train",
                          output_size=cfg.data.patch_size), "cpu")

    # arco_tpu/cli/pretrain_2d.py:104-153, epoch after epoch
    jds = jdatasets.SliceDataset(cfg.data.root_path, "train",
                                 output_size=cfg.data.patch_size)
    sampler = jsamplers.TwoStreamBatchSampler(
        list(range(23)), list(range(23, len(jds))), 2, 1, seed=SEED)
    host_rng = np.random.RandomState(SEED)
    bank = JaxDeviceSliceBank.from_dataset(jds) if device_data else None

    def jax_batches():
        while True:
            for idxs in sampler:
                if bank is not None:
                    images, labels = bank.gather(bank.draw_params(host_rng,
                                                                  idxs))
                else:
                    samples = [jds.get(i, host_rng) for i in idxs]
                    images = np.stack([s["image"] for s in samples])
                    labels = np.stack([s["label"] for s in samples])
                yield np.asarray(images), np.asarray(labels)

    want = jax_batches()
    # 23 batches make an epoch of the labeled stream: cross into the next
    for _ in range(26):
        images, labels = next(port)
        w_images, w_labels = next(want)
        np.testing.assert_array_equal(images.permute(0, 2, 3, 1).numpy(),
                                      w_images)
        np.testing.assert_array_equal(labels.numpy(), w_labels)


# ----------------------------------------------------------------- handoff

def test_stage2_resume_starts_from_the_pretrain_weights(pretrained,
                                                        monkeypatch):
    seen = {}
    make_step = train_arco_2d.make_arco_step

    def recording_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def first_step_records(state, batch, draws=None):
            if not seen:
                for name in ("model", "ema_model"):
                    seen[name] = {k: v.clone() for k, v in
                                  getattr(state, name).state_dict().items()}
            return step(state, batch, draws)
        return first_step_records

    monkeypatch.setattr(train_arco_2d, "make_arco_step", recording_make_step)
    train_arco_2d.main(_argv(pretrained["data"], pretrained["model_dir"],
                             "ACDC/arco", 2, "--resume", "ACDC/pre")
                       + SMALL_ARCO)
    snap = os.path.join(pretrained["model_dir"], "ACDC/arco_1_labeledfinal",
                        "unet")
    with open(os.path.join(snap, "log.txt")) as f:
        assert "loading stage-1 checkpoint iter_6" in f.read()
    want = ckpt.load_model_params(pretrained["snap"], 6)
    for name in ("model", "ema_model"):
        assert seen[name].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(seen[name][k], v), f"{name}.{k}"
    # the running statistics are the pretrain's, not a fresh init's
    assert not torch.equal(want["encoder.in_conv.conv_conv.1.running_var"],
                           torch.ones(16))


# ------------------------------------------------------------------ freeze

@pytest.mark.parametrize("enc,dec", [(True, True), (True, False),
                                     (False, True), (False, False)])
def test_snapshot_suffix_matches_jax(enc, dec):
    assert freeze.snapshot_suffix(enc, dec) == jfreeze.snapshot_suffix(enc,
                                                                       dec)


@pytest.mark.parametrize("enc,dec,suffix", [
    (True, False, "_train_encoder"), (False, True, "_train_decoder")])
def test_freeze_flags_pick_the_snapshot_dir(pretrained, enc, dec, suffix):
    pretrain_2d.main(_argv(pretrained["data"], pretrained["model_dir"],
                           "ACDC/frz", 1, "--train_encoder", str(enc),
                           "--train_decoder", str(dec)))
    snap = os.path.join(pretrained["model_dir"], f"ACDC/frz_1_labeled{suffix}",
                        "unet")
    tree = torch.load(os.path.join(snap, "iter_1", "state.pt"),
                      weights_only=True)
    start, _ = _state(seed=SEED)   # only the parameter names are read
    frozen = freeze.model_param_labels(start.model, enc, dec)
    n_frozen = sum(v == "freeze" for v in frozen.values())
    n_model = len(frozen)
    n_heads = sum(len(list(getattr(start, n).parameters())) for n in
                  ("latent_head", "latent_predictor", "outputs_head",
                   "outputs_predictor"))
    assert len(tree["optimizer"]["state"]) == n_model - n_frozen + n_heads
    assert 0 < n_frozen < n_model


def test_part_of_refuses_other_models():
    with pytest.raises(ValueError, match="encoder/decoder"):
        freeze.apply_freeze(torch.nn.Linear(2, 2), True, False)
    model = net_factory("unet", class_num=NC)
    assert len(freeze.apply_freeze(model, True, True)) \
        == len(list(model.parameters()))
    trainable = freeze.apply_freeze(model, False, True)
    assert all(p.requires_grad == any(p is q for q in trainable)
               for p in model.parameters())
    assert all(not p.requires_grad for p in model.encoder.parameters())
