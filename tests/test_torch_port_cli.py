"""The port's stage-2 CLI, checkpoints and eval CLI on the CPU, at 32x32 with
small banks (port only, no JAX).

- ``train_arco_2d`` trains 2 steps and checkpoints; a rerun with a higher
  ``--max_iterations`` resumes from full_iter_2 and trains to 4.
- A full-state checkpoint brings the weights, EMA copies, optimizer,
  step and generator back exactly (bit for bit); the default
  RESUME_EXCLUDE leaves the bank and pool freshly initialized, and with
  ``exclude=()`` 2 steps + save + restore + 2 steps equal 4 straight steps
  bit for bit (the CPU kernels are deterministic at one thread).
- ``test_2d`` evaluates the saved checkpoint, writes its prediction
  volumes, and sweeps the saved checkpoints.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from arco_torch.cli import test_2d, train_arco_2d
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.data.synthetic import make_acdc_like
from arco_torch.models import net_factory
from arco_torch.train import arco2d
from arco_torch.train import checkpoint as ckpt
from arco_torch.utils import volume_io

torch.set_num_threads(1)

HW, NC = 32, 3
SMALL = ["--arco.K", "2", "--arco.num_queries", "16",
         "--arco.num_negatives", "8", "--arco.memobank_size", "64",
         "--arco.memobank_size_bg", "64", "--arco.memobank_enqueue", "16",
         "--arco.topk", "2"]
# 4 classes and thresholds low enough for the random teacher to enqueue
# bank keys (a negative ranks 3rd to 19th among the classes)
STATE_NC = 4
CFG = ArcoConfig(K=2, num_queries=16, num_negatives=8, memobank_size=64,
                 memobank_size_bg=64, memobank_enqueue=16, topk=2,
                 strong_threshold=0.3, weak_threshold=0.3)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    data = make_acdc_like(str(base / "ACDC"), n_train=30, n_val=2,
                          size=(40, 40), num_classes=NC)
    argv = ["--root_path", data, "--exp", "ACDC/cli", "--labeled_num", "1",
            "--device", "cpu", "--patch_size", str(HW), str(HW),
            "--num_classes", str(NC), "--batch_size", "2",
            "--labeled_bs", "1", "--ckpt_every", "2", "--log_every", "1",
            "--snapshot_dir", str(base / "model"),
            "--compute_dtype", "float32"] + SMALL
    train_arco_2d.main(argv + ["--max_iterations", "2"])
    train_arco_2d.main(argv + ["--max_iterations", "4"])
    snap = os.path.join(str(base / "model"), "ACDC/cli_1_labeledfinal",
                        "unet")
    return {"data": data, "model_dir": str(base / "model"), "snap": snap}


def test_cli_trains_checkpoints_and_resumes(trained):
    snap = trained["snap"]
    names = set(os.listdir(snap))
    assert {"iter_2", "iter_4", "full_iter_2", "full_iter_4"} <= names
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    assert "resuming full train state from full_iter_2" in log
    assert "device data path: 23 + 7 slices staged on cpu" in log
    assert "iteration 4 : loss" in log
    with open(os.path.join(snap, "record.pkl"), "rb") as f:
        history = pickle.load(f)
    assert len(history) == 4 and np.isfinite(history).all()
    tree = torch.load(os.path.join(snap, "full_iter_4", "state.pt"),
                      weights_only=True)
    assert tree["step"] == 4 and "memobank" not in tree


def _test_2d_argv(trained):
    return ["--root_path", trained["data"], "--exp", "ACDC/cli",
            "--labeled_num", "1", "--num_classes", str(NC), "--snapshot_dir",
            trained["model_dir"], "--input_size", str(HW), str(HW),
            "--device", "cpu"]


def test_test_2d_prints_the_metrics(trained, capsys):
    result = test_2d.main(_test_2d_argv(trained))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["iteration"] == 4
    for k in ("mean_dice", "mean_jc", "mean_hd95", "mean_asd"):
        assert np.isfinite(line[k])
    assert 0.0 <= line["mean_dice"] <= 1.0
    assert result["raw"].shape == (2, NC - 1, 4)


def test_test_2d_saves_the_predictions(trained):
    """--save_predictions writes each case's prediction, image and label
    volumes and gives the metrics of a plain run."""
    want = test_2d.main(_test_2d_argv(trained))
    got = test_2d.main(_test_2d_argv(trained) + ["--save_predictions", "1"])
    np.testing.assert_array_equal(got["raw"], want["raw"])
    out = os.path.join(trained["model_dir"], "ACDC/cli_1_labeledfinal",
                       "unet_predictions")
    for case in ("patient100_volume", "patient101_volume"):
        for kind in ("pred", "img", "gt"):
            path = [n for n in os.listdir(out)
                    if n.startswith(f"{case}_{kind}.")]
            assert len(path) == 1
            vol = volume_io.load_volume(os.path.join(out, path[0]))
            assert vol.shape == (4, 40, 40)


def test_test_2d_sweeps_the_checkpoints(trained, capsys):
    best = test_2d.main(_test_2d_argv(trained) + ["--startEpoch", "2",
                                                  "--stepEpoch", "2"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()
             if ln.startswith("{")]
    assert [ln["iteration"] for ln in lines[:-1]] == [2, 4]
    assert lines[-1]["best_iteration"] == best[0] in (2, 4)


def _state(seed=0):
    torch.manual_seed(seed)
    mods = arco2d.make_arco_modules(net_factory("unet", class_num=STATE_NC),
                                    HW, HW, batch_size=1, total_batch=2)
    state = arco2d.init_arco_state(mods, CFG, (1, 1, HW, HW), OptimConfig(),
                                   seed=seed, device="cpu",
                                   compute_dtype=torch.float32)
    step = arco2d.make_arco_step(mods, CFG, num_classes=STATE_NC,
                                 max_iterations=100, device="cpu")
    return state, step


def _batches(n):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        label = rs.randint(0, STATE_NC, (1, HW, HW)).astype(np.int32)
        out.append({"image_l": torch.from_numpy(
            label[:, None].astype(np.float32) / 3 + 0.1 * rs.randn(
                1, 1, HW, HW).astype(np.float32)),
            "label_l": torch.from_numpy(label),
            "image_u": torch.from_numpy(rs.rand(1, 1, HW, HW)
                                        .astype(np.float32))})
    return out


def _assert_same_state(a, b, banks=True):
    for name in ("model", "ema_model", "feature_extractor",
                 "k_feature_extractor", "q_representation"):
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
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    if banks:
        assert torch.equal(a.memobank.data, b.memobank.data)
        assert torch.equal(a.memobank.ptr, b.memobank.ptr)
        assert torch.equal(a.memobank.count, b.memobank.count)
        assert torch.equal(a.random_pool, b.random_pool)
        assert a.random_pool_ptr == b.random_pool_ptr


def test_full_state_comes_back_exactly(tmp_path):
    state, step = _state()
    for batch in _batches(2):
        step(state, batch)
    ckpt.save_full_state(str(tmp_path), state.step, state)
    fresh, _ = _state(seed=5)
    ckpt.restore_full_state(str(tmp_path), 2, fresh)
    _assert_same_state(state, fresh, banks=False)
    # the default exclude refreshes the bank and the pool
    init, _ = _state(seed=5)
    assert torch.equal(fresh.memobank.data, init.memobank.data)
    assert torch.equal(fresh.random_pool, init.random_pool)
    assert fresh.random_pool_ptr == 0
    assert not torch.equal(state.memobank.data, init.memobank.data)
    assert not torch.equal(state.random_pool, init.random_pool)


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    batches = _batches(4)
    straight, step = _state()
    for batch in batches:
        step(straight, batch)
    first, step = _state()
    for batch in batches[:2]:
        step(first, batch)
    ckpt.save_full_state(str(tmp_path), 2, first, exclude=())
    resumed, step = _state(seed=5)
    ckpt.restore_full_state(str(tmp_path), 2, resumed, exclude=())
    _assert_same_state(first, resumed)
    for batch in batches[2:]:
        step(resumed, batch)
    _assert_same_state(straight, resumed)


def test_keep_prunes_old_full_checkpoints_and_fallback_resume(tmp_path):
    state, step = _state()
    for s in (2, 4, 6):
        state.step = s
        ckpt.save_full_state(str(tmp_path), s, state)
    assert ckpt.latest_full_step(str(tmp_path)) == 6
    assert sorted(n for n in os.listdir(tmp_path)) \
        == ["full_iter_4", "full_iter_6"]
    step(state, _batches(1)[0])
    ckpt.save_model_state(str(tmp_path), 7, state)
    assert ckpt.latest_step(str(tmp_path)) == 7
    fresh, _ = _state(seed=5)
    ckpt.restore_model_fallback(str(tmp_path), 7, fresh, OptimConfig())
    assert fresh.step == 7 and not fresh.optimizer.state_dict()["state"]
    for k, v in state.ema_model.state_dict().items():
        assert torch.equal(fresh.ema_model.state_dict()[k], v)
    assert ckpt.resolve_steps(str(tmp_path), None, None, None, 1) == [7]
    with pytest.raises(SystemExit):
        ckpt.resolve_steps(str(tmp_path), 7, 1, None, 1)
