"""The port's 3D stage-2 CLI and its evaluation CLI on the CPU, at 32x32x16
patches of a synthetic LA tree (48x48x32 h5 volumes) with small banks.

- ``train_arco_3d`` trains 4 steps and checkpoints every 2; a rerun to 6
  resumes from full_iter_4 and ends in a straight 6-step run's step, LR
  and generator state (the batch stream restarts at a resume, as in JAX,
  and the bank and pool are left out of the resume state, so the weights
  differ). ``eqv_on_log_only`` (log every 2) alternates the two step
  functions: the eqv leg runs on the logged iterations only.
- Its batches are the ones arco_tpu's CLI draws from the same tree and seed
  (arco_tpu.data.device_bank: two_stream_device_batches over two
  DeviceVolumeBanks), exactly.
- ``--resume`` starts a run from another experiment's newest V-Net
  iter_<N>; ``--pretrained_path`` is accepted and ignored, as in JAX.
- ``test_3d`` evaluates iter_6 by sliding window, with the case on the
  device or summed on the host (the same metrics), and sweeps checkpoints.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from arco_tpu.data import datasets as jdatasets
from arco_tpu.data import device_bank as jbank

from arco_torch.cli import test_3d, train_arco_3d
from arco_torch.data.synthetic import make_la_like
from arco_torch.train.schedule import poly_lr

torch.set_num_threads(1)

PATCH = ("32", "32", "16")
SMALL = ["--arco.K", "2", "--arco.num_queries", "16",
         "--arco.num_negatives", "8", "--arco.memobank_size", "128",
         "--arco.memobank_size_bg", "128", "--arco.memobank_enqueue", "32",
         "--arco.topk", "2"]


def _argv(root, model_dir, exp, iterations, *extra):
    return ["--root_path", root, "--exp", exp, "--labeled_num", "2",
            "--device", "cpu", "--patch_size", *PATCH, "--batch_size", "4",
            "--labeled_bs", "2", "--snapshot_dir", model_dir,
            "--compute_dtype", "float32", "--seed", "5", "--log_every", "2",
            "--ckpt_every", "2", "--max_iterations", str(iterations)] \
        + SMALL + list(extra)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Train 4 + 2 (resumed) and a straight 6, recording each step call:
    (its step function's compute_eqv, the batch, loss_eqv)."""
    base = tmp_path_factory.mktemp("cli3d")
    root = make_la_like(str(base / "LA"), n_train=6, size=(48, 48, 32))
    model_dir = str(base / "model")
    calls = []
    make = train_arco_3d.make_arco_step

    def recording(modules, cfg, *args, **kwargs):
        fn = make(modules, cfg, *args, **kwargs)

        def step(state, batch, draws=None):
            m = fn(state, batch, draws)
            calls.append((cfg.compute_eqv,
                          {k: v.clone() for k, v in batch.items()},
                          float(m["loss_eqv"])))
            return m
        return step

    mp = pytest.MonkeyPatch()
    mp.setattr(train_arco_3d, "make_arco_step", recording)
    try:
        train_arco_3d.main(_argv(root, model_dir, "LA/cli", 4))
        train_arco_3d.main(_argv(root, model_dir, "LA/cli", 6))
        resumed_calls = list(calls)
        train_arco_3d.main(_argv(root, model_dir, "LA/straight", 6))
    finally:
        mp.undo()
    snap = lambda exp: os.path.join(model_dir, f"{exp}_2_labeledfinal",
                                    "vnet")
    return {"root": root, "model_dir": model_dir, "snap": snap("LA/cli"),
            "straight": snap("LA/straight"), "calls": resumed_calls}


def test_cli_trains_checkpoints_and_resumes(trained):
    snap = trained["snap"]
    assert {"iter_2", "iter_4", "iter_6", "full_iter_4", "full_iter_6"} \
        <= set(os.listdir(snap))
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    for want in ("device data path: 2 + 4 volumes staged on cpu",
                 "resuming full train state from full_iter_4",
                 "iteration 6 : loss", "vol/s"):
        assert want in log
    with open(os.path.join(snap, "record.pkl"), "rb") as f:
        history = pickle.load(f)
    assert len(history) == 6 and np.isfinite(history).all()
    load = lambda d: torch.load(os.path.join(d, "full_iter_6", "state.pt"),
                                weights_only=True)
    resumed, straight = load(snap), load(trained["straight"])
    assert resumed["step"] == straight["step"] == 6
    assert torch.equal(resumed["generator"], straight["generator"])
    lr = resumed["optimizer"]["param_groups"][0]["lr"]
    assert lr == straight["optimizer"]["param_groups"][0]["lr"] \
        == poly_lr(0.01, 5, 6)


def test_eqv_leg_runs_on_logged_iterations_only(trained):
    calls = trained["calls"]
    assert [c[0] for c in calls] == [False, True] * 3
    assert all((c[2] > 0) == c[0] for c in calls)
    rows = [json.loads(ln) for ln in open(os.path.join(
        trained["snap"], "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [2, 4, 6]
    assert all(r["loss_eqv"] > 0 and "volumes_per_sec" in r for r in rows)


def test_cli_batches_equal_the_jax_clis(trained):
    """The first run's 4 batches against JAX's device bank stream for the
    same splits and seed."""
    patch = tuple(int(p) for p in PATCH)
    splits = [jdatasets.LAHeartDataset(trained["root"], "train", index=2,
                                       label_type=t, patch_size=patch)
              for t in (1, 0)]
    jgen = jbank.two_stream_device_batches(
        *(jbank.DeviceVolumeBank.from_dataset(s, patch) for s in splits),
        2, 2, seed=5)
    for _, got, _ in trained["calls"][:4]:
        want = next(jgen)
        for k in ("image_l", "image_u"):
            np.testing.assert_array_equal(got[k].movedim(1, -1).numpy(),
                                          np.asarray(want[k]))
        np.testing.assert_array_equal(got["label_l"].numpy(),
                                      np.asarray(want["label_l"]))


def test_resume_handoff_loads_a_vnet_checkpoint(trained):
    """--resume: the student starts from LA/cli's newest iter_<N>."""
    train_arco_3d.main(_argv(trained["root"], trained["model_dir"],
                             "LA/handoff", 0, "--resume", "LA/cli"))
    snap = os.path.join(trained["model_dir"], "LA/handoff_2_labeledfinal",
                        "vnet")
    with open(os.path.join(snap, "log.txt")) as f:
        assert "loading stage-1 checkpoint iter_6" in f.read()
    got = torch.load(os.path.join(snap, "full_iter_0", "state.pt"),
                     weights_only=True)
    want = torch.load(os.path.join(trained["snap"], "iter_6", "state.pt"),
                      weights_only=True)
    for name in ("model", "ema_model"):
        for k, v in want["model"].items():
            assert torch.equal(got[name][k], v), f"{name}.{k}"


def test_pretrained_path_is_refused(trained, tmp_path):
    """--pretrained_path is accepted and ignored, as JAX's 3D CLIs never
    read it: the run starts from the same weights as one without it (the
    file does not exist)."""
    for exp, extra in (("LA/x", ("--pretrained_path", "w.pth")),
                       ("LA/y", ())):
        train_arco_3d.main(_argv(trained["root"], str(tmp_path), exp, 0,
                                 *extra))
    load = lambda exp: torch.load(os.path.join(
        str(tmp_path), f"{exp}_2_labeledfinal", "vnet", "full_iter_0",
        "state.pt"), weights_only=True)["model"]
    got, want = load("LA/x"), load("LA/y")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _test_3d_argv(trained, *extra):
    return ["--root_path", trained["root"], "--exp", "LA/cli",
            "--labeled_num", "2", "--snapshot_dir", trained["model_dir"],
            "--patch_size", *PATCH, "--device", "cpu", *extra]


def test_test_3d_on_the_device_and_the_host(trained, capsys):
    dev = test_3d.main(_test_3d_argv(trained))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["iteration"] == 6
    for k in ("mean_dice", "mean_jc", "mean_hd95", "mean_asd"):
        assert np.isfinite(line[k])
    assert 0.0 <= line["mean_dice"] <= 1.0
    assert dev["raw"].shape == (2, 1, 4)
    host = test_3d.main(_test_3d_argv(trained, "--device_eval", "0"))
    np.testing.assert_array_equal(host["raw"], dev["raw"])


def test_test_3d_sweeps_the_checkpoints(trained, capsys):
    best = test_3d.main(_test_3d_argv(trained, "--startEpoch", "2",
                                      "--stepEpoch", "2"))
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()
             if ln.startswith("{")]
    assert [ln["iteration"] for ln in lines[:-1]] == [2, 4, 6]
    assert lines[-1]["best_iteration"] == best[0] in (2, 4, 6)
