"""The port's method-quality gate scripts against the JAX package's.

``scripts/torch_validate_semi_synthetic.py`` (the port's) is held against
``scripts/validate_semi_synthetic.py`` (JAX's, the oracle), both imported
by path:
- the data of both 2D tasks bit for bit (``np.array_equal``, same dtype)
  at the JAX script's sizes, seeds 0 and 1; noisy3d's at the gate's
  protocol (sigma 0.26, 2 labeled volumes), seed 0;
- ``dice`` exactly, on seeded pairs and with a class absent;
- every arm's config, step count and seed field for field (2D and
  noisy3d), the optimizer's settings, and the batch-index stream of
  ``run`` for 5 steps (2D and 3D);
- ``evaluate`` at 32x32 from one set of U-Net weights carried from flax
  (``compat/from_flax.py``), both in f32 on the CPU: logits within atol
  1e-4, the same per-image Dice and the same mean;
- one ``run_seed`` of each task on the CPU at 32x32 (noisy3d at
  16x16x16; 2 warm and 2 tune steps, small banks and pool): the artifact
  keys, every Dice in [0, 1], finite losses; noisy3d's confmask record;
- the script imports neither JAX nor the JAX package (``ast``).

``scripts/torch_validate_natural.py`` against ``scripts/validate_natural.py``
with ``--mechanism striped``: the fixture's JPEGs and PNGs byte for byte,
the two CLIs' argv of every arm (module paths aside), one seed through the
port's CLIs on the CPU at 2 iterations an arm, and no JAX import.
"""

import ast
import dataclasses
import filecmp
import importlib.util
import inspect
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.compat.from_flax import unet_state_dict_from_flax
from arco_torch.config import ArcoConfig
from arco_torch.models import net_factory

from test_torch_port_supervised import seeded_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "arco_tpu")
SMALL = dict(K=4, num_queries=16, num_negatives=8, memobank_size=64,
             memobank_size_bg=64, memobank_enqueue=16, topk=2)
ALL_ARMS = ("sup", "arco", "arco_nounsup", "arco_norevisit", "arco_noreco",
            "arco_unsuponly", "arco_confmask")


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_GATE = _load("jax_validate_semi_synthetic",
                 "scripts/validate_semi_synthetic.py")
GATE = _load("torch_validate_semi_synthetic",
             "scripts/torch_validate_semi_synthetic.py")
JAX_NATURAL = _load("jax_validate_natural", "scripts/validate_natural.py")
# the natural script imports the gate script by name, from scripts/
sys.path.insert(0, str(ROOT / "scripts"))
NATURAL = _load("torch_validate_natural", "scripts/torch_validate_natural.py")


@pytest.mark.parametrize("task", ["shifted", "striped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_make_data_is_bit_identical(task, seed):
    want = JAX_GATE.make_data(task, seed)
    got = GATE.make_data(task, seed)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_noisy3d_data_is_bit_identical(monkeypatch):
    """At the gate's protocol (the JAX artifact's noise_sigma 0.26 and
    labeled_volumes 2): JAX's script reads them from its globals."""
    monkeypatch.setattr(JAX_GATE, "NOISE3D", 0.26)
    monkeypatch.setattr(JAX_GATE, "LABELED3D", 2)
    want = JAX_GATE.make_data("noisy3d", 0)
    got = GATE.make_data("noisy3d", 0)
    assert [g.shape for g in got] == [(2, 64, 64, 32, 1), (2, 64, 64, 32),
                                      (128, 64, 64, 32, 1),
                                      (32, 64, 64, 32, 1), (32, 64, 64, 32)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_constants_match():
    for name in ("HW", "B", "K", "N_LABELED", "N_UNLABELED", "N_VAL",
                 "N_WARM", "N_TUNE", "GAIN_LO", "GAIN_HI", "OFF_MAX", "VOL",
                 "B3_L", "B3"):
        assert getattr(GATE, name) == getattr(JAX_GATE, name), name
    # noisy3d's noise and labeled volumes: the JAX artifact's protocol (its
    # script's defaults differ; the artifact's run set them by flag)
    with open(ROOT / "docs/artifacts/quality_gate/"
              "quality_gate_noisy3d_confmask.json") as f:
        jax3d = json.load(f)
    assert (GATE.NOISE3D, GATE.LABELED3D) == \
        (jax3d["noise_sigma"], jax3d["labeled_volumes"])
    for name in ("HW", "K_CLS", "N_TRAIN", "N_VAL", "LABEL_NUM", "ITERS",
                 "WARM_ITERS", "MODEL", "SMALL", "SUP_OFF"):
        assert getattr(NATURAL, name) == getattr(JAX_NATURAL, name), name


def test_resize_bicubic_is_jax_image_resize():
    """The bias field's upsampling, to the bit, beyond the two tasks' own
    draws: 20 seeded coarse grids at 256 and at 32."""
    rs = np.random.RandomState(3)
    for hw in (256, 32):
        for _ in range(10):
            coarse = rs.uniform(-1.0, 1.0, (4, 4)).astype(np.float32)
            want = np.asarray(jax.image.resize(jnp.asarray(coarse),
                                               (hw, hw), "bicubic"))
            got = GATE.resize_bicubic(coarse, hw)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dice_is_equal():
    rs = np.random.RandomState(0)
    pairs = [(rs.randint(0, 3, (16, 16)), rs.randint(0, 3, (16, 16)))
             for _ in range(4)]
    # class 2 absent from both: skipped; every class absent: 1.0
    pairs.append((rs.randint(0, 2, (16, 16)), rs.randint(0, 2, (16, 16))))
    pairs.append((np.zeros((8, 8), int), np.zeros((8, 8), int)))
    # class 2 predicted but absent from the label: scores 0
    pairs.append((np.full((8, 8), 2), rs.randint(0, 2, (8, 8))))
    for pred, label in pairs:
        assert GATE.dice(pred, label, 3) == JAX_GATE.dice(pred, label, 3)


def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _arm_calls(monkeypatch, task="shifted"):
    """Each script's run_seed of ``task`` over every arm, with ``run``
    recording (tag, config, steps, seed) and the data and evaluation
    stubbed."""
    tiny = (np.zeros((2, 4, 4, 1), np.float32), np.zeros((2, 4, 4), np.int32),
            np.zeros((4, 4, 4, 1), np.float32),
            np.zeros((4, 4, 4, 1), np.float32), np.zeros((4, 4, 4), np.int32))
    calls = {"jax": [], "port": []}

    def jax_run(cfg, tag, steps, *args, init_params=None, init_stats=None,
                seed=0):
        calls["jax"].append((tag, _cfg_fields(cfg), steps, seed))
        return None, None, None

    def port_run(cfg, tag, steps, data, device, warm=None, seed=0, hw=0):
        calls["port"].append((tag, _cfg_fields(cfg), steps, seed))
        return torch.nn.Linear(1, 1), {}

    for mod, run in ((JAX_GATE, jax_run), (GATE, port_run)):
        monkeypatch.setattr(mod, "make_data", lambda *a, **k: tiny)
        monkeypatch.setattr(mod, "run", run)
        monkeypatch.setattr(mod, "evaluate", lambda *a, **k: 0.5)
        monkeypatch.setattr(mod, "evaluate_buckets", lambda *a, **k: [0.5])
    JAX_GATE.run_seed(task, 7, jnp.float32, arms=ALL_ARMS, n_tune=11,
                      n_warm=5)
    GATE.run_seed(task, 7, "cpu", arms=ALL_ARMS, n_tune=11, n_warm=5)
    return calls


@pytest.mark.parametrize("task", ["shifted", "noisy3d"])
def test_configs_steps_and_seeds_match(monkeypatch, task):
    """Warmup, both arms and the five triage arms: the same ArcoConfig on
    every field (the two dataclasses have the same fields), the same step
    count and seed, in the same order; noisy3d's ARCO arms with the 3D
    trainer's method config."""
    jax_fields = {f.name for f in dataclasses.fields(JaxArcoConfig)}
    assert {f.name for f in dataclasses.fields(ArcoConfig)} == jax_fields
    calls = _arm_calls(monkeypatch, task)
    assert len(calls["port"]) == len(calls["jax"]) == 8
    for (tag_p, cfg_p, steps_p, seed_p), (tag_j, cfg_j, steps_j, seed_j) in \
            zip(calls["port"], calls["jax"]):
        assert tag_p == tag_j
        assert cfg_p == cfg_j, tag_p
        assert (steps_p, seed_p) == (steps_j, seed_j), tag_p
    assert [c[2:] for c in calls["port"][:3]] == [(5, 7), (11, 8), (11, 8)]
    arco = calls["port"][2][1]
    assert (arco["memobank_init"], arco["compute_eqv"]) == \
        (("randn", False) if task == "noisy3d" else ("zeros", True))


def test_optimizer_matches_make_optimizer():
    """make_optimizer(0.01, steps): SGD, nesterov momentum 0.9, weight decay
    1e-4, poly 0.9 over the arm's steps."""
    want = inspect.signature(jax_make_optimizer).parameters
    o = GATE.OPTIM
    assert o.base_lr == 0.01
    assert o.weight_decay == want["weight_decay"].default
    assert o.momentum == want["momentum"].default
    assert o.nesterov == want["nesterov"].default
    assert o.poly_power == want["power"].default


@pytest.mark.parametrize("nd", [2, 3])
def test_batch_index_stream_matches(monkeypatch, nd):
    """The first 5 batches of ``run``: images that carry their own index,
    through each script's real loop with the model and step stubbed (3-D
    images take the 3D branch, bs 2 + 2)."""
    n_l, n_u, steps, seed = 2, 128, 5, 3
    img_l = np.arange(n_l, dtype=np.float32).reshape((n_l,) + (1,) * (nd + 1))
    img_u = np.arange(n_u, dtype=np.float32).reshape((n_u,) + (1,) * (nd + 1))
    lab_l = np.zeros((n_l,) + (1,) * nd, np.int32)
    seen = {"jax": [], "port": []}

    def record(key, batch):
        seen[key].append(tuple(np.asarray(batch[k]).reshape(-1).astype(int)
                               .tolist() for k in ("image_l", "image_u")))

    def jax_step(state, batch):
        record("jax", batch)
        return state, {"loss": 0.0}

    def port_step(state, batch):
        record("port", batch)
        return {"loss": torch.zeros(())}

    state = SimpleNamespace(params={"model": {}}, batch_stats={"model": {}})
    monkeypatch.setattr(JAX_GATE, "make_arco_modules", lambda *a, **k: None)
    monkeypatch.setattr(JAX_GATE, "init_arco_state", lambda *a, **k: state)
    monkeypatch.setattr(JAX_GATE, "make_arco_step",
                        lambda *a, **k: jax_step)
    JAX_GATE.run(None, "t", steps, img_l, lab_l, img_u, jnp.float32,
                 seed=seed)

    monkeypatch.setattr(GATE, "make_arco_modules", lambda *a, **k: None)
    monkeypatch.setattr(GATE, "init_arco_state",
                        lambda *a, **k: SimpleNamespace(model=None))
    monkeypatch.setattr(GATE, "make_arco_step", lambda *a, **k: port_step)
    nchw = lambda x: torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, 1)))
    data = (nchw(img_l), torch.from_numpy(lab_l), nchw(img_u))
    GATE.run(None, "t", steps, data, torch.device("cpu"), seed=seed, hw=1)

    assert len(seen["jax"]) == steps
    assert seen["port"] == seen["jax"]
    b = (GATE.B3_L, GATE.B3 - GATE.B3_L) if nd == 3 else (GATE.B, GATE.B)
    assert [len(i) for i in seen["port"][0]] == list(b)
    index = GATE.batch_indices(seed, n_l, n_u, *b)
    assert [tuple(a.tolist() for a in next(index))
            for _ in range(steps)] == seen["jax"]


def test_evaluate_matches_jax():
    """One set of U-Net weights (seeded, of flax's shapes) in both
    packages, f32 on the CPU, on 6 validation images at 32x32 (the last
    chunk of 4 padded): logits within atol 1e-4, the same per-image Dice,
    the same mean through each script's evaluate."""
    hw, n_val = 32, 6
    *_, img_v, lab_v = GATE.make_data("shifted", 0, hw=hw, n_unlabeled=1,
                                      n_val=n_val)
    jmodel = JAX_GATE.net_factory("unet", in_chns=1, class_num=JAX_GATE.K,
                                  dtype=jnp.float32)
    params, stats = seeded_variables(jmodel, (JAX_GATE.B, hw, hw, 1))
    model = net_factory("unet", in_chns=1, class_num=GATE.K)
    model.load_state_dict(unet_state_dict_from_flax(params, stats))
    device = torch.device("cpu")

    @jax.jit
    def jax_logits(x):
        out, _, _ = jmodel.apply({"params": params, "batch_stats": stats}, x,
                                 train=False,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        return out

    model.eval()
    jax_pred = []
    for i in range(0, n_val, GATE.B):
        chunk = img_v[i:i + GATE.B]
        chunk = np.concatenate([chunk, chunk[:GATE.B - len(chunk)]])
        want = np.asarray(jax_logits(jnp.asarray(chunk)))
        got = GATE.logits(model, chunk, device).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        jax_pred.append(want.argmax(-1)[:n_val - i])
    model.train()
    jax_pred = np.concatenate(jax_pred)
    got_pred = GATE.predict(model, img_v, device)
    assert model.training
    want_dice = [JAX_GATE.dice(p, l, 3) for p, l in zip(jax_pred, lab_v)]
    got_dice = [GATE.dice(p, l, 3) for p, l in zip(got_pred, lab_v)]
    assert got_dice == want_dice
    assert 0 < np.mean(want_dice) < 1
    assert GATE.evaluate(model, img_v, lab_v, device) == \
        JAX_GATE.evaluate(jmodel, params, stats, img_v, lab_v)


def test_noisy3d_run_seed_on_the_cpu():
    """The 3D branch through the V-Net at 16x16x16, its three arms 2 steps
    each: finite losses, no kernel launch on the CPU, and the confmask
    record the artifact holds (``confmask_run``)."""
    out = GATE.run_seed("noisy3d", 0, "cpu", arms=GATE.ARMS_3D, n_tune=2,
                        n_warm=2, n_unlabeled=4, n_val=4, cfg_override=SMALL,
                        vol=(16, 16, 16))
    run = GATE.confmask_run(out)
    assert run["arco_dice"] == out["arco_confmask_dice"]
    assert run["ref_formula_arco_dice"] == out["arco_dice"]
    assert run["gain"] == round(out["arco_confmask_dice"]
                                - out["supervised_dice"], 4)
    assert all(0.0 <= run[k] <= 1.0 for k in
               ("warmup_dice", "supervised_dice", "arco_dice",
                "ref_formula_arco_dice"))
    assert set(run["timing"]) == {"warmup", "supervised", "arco",
                                  "arco_confmask"}
    for rec in run["timing"].values():
        assert rec["steps"] == 2 and rec["nonfinite_losses"] == 0
        assert np.isfinite(rec["final_loss"])
        assert not any(rec["launches"].values())
    summary = GATE.summarize([run, {**run, "seed": 1}])
    assert summary["min_gain"] == run["gain"]
    assert GATE.artifact_name("noisy3d") == \
        "quality_gate_noisy3d_confmask.json"


def test_noisy3d_needs_the_confmask_arm():
    with pytest.raises(SystemExit, match="arco_confmask"):
        GATE.main(["--task", "noisy3d", "--arms", "sup", "arco",
                   "--device", "cpu"])


@pytest.mark.parametrize("task", ["shifted", "striped"])
def test_run_seed_on_the_cpu(task):
    """The keys tests/test_quality_gate.py::test_artifact_matches_task
    reads, every Dice in [0, 1], each arm's record, and no kernel launch
    (the CPU runs the plain versions)."""
    out = GATE.run_seed(task, 0, "cpu", n_tune=2, n_warm=2, hw=32,
                        n_unlabeled=8, n_val=8, cfg_override=SMALL)
    assert {"seed", "warmup_dice", "supervised_dice", "supervised_buckets",
            "arco_dice", "arco_buckets", "gain"} <= set(out)
    dices = [out["warmup_dice"], out["supervised_dice"], out["arco_dice"],
             *out["supervised_buckets"], *out["arco_buckets"]]
    assert all(0.0 <= d <= 1.0 for d in dices)
    assert len(out["arco_buckets"]) == 4
    assert abs(out["gain"] - (out["arco_dice"] - out["supervised_dice"])) \
        < 2e-4
    for arm in ("warmup", "supervised", "arco"):
        rec = out["timing"][arm]
        assert rec["steps"] == 2 and rec["nonfinite_losses"] == 0
        assert np.isfinite(rec["final_loss"])
        assert not any(rec["launches"].values())


def test_merge_and_summary(tmp_path):
    """Runs merge by seed (a rerun's seed replaces the old one, from
    another commit of the same sources too), the summary is recomputed,
    and an artifact of another protocol is refused."""
    head = {"task": "shifted", "hw": 256, "n_labeled": 2,
            "n_unlabeled": 128, "warm_steps": 150, "tune_steps": 1500,
            "backend": "cuda", "compute_dtype": "bfloat16", "device": "d",
            "torch": "t", "commit": "c", "source_sha256": "s"}

    def run(seed, sup, arco):
        return {"seed": seed, "supervised_dice": sup, "arco_dice": arco,
                "gain": round(arco - sup, 4)}
    path = tmp_path / GATE.artifact_name("shifted")
    first = GATE.merge(str(path), {**head, "runs": [run(2, 0.8, 0.9),
                                                    run(0, 0.7, 0.72)]})
    path.write_text(json.dumps(first))
    merged = GATE.merge(str(path), {**head, "commit": "c2",
                                    "runs": [run(1, 0.6, 0.7),
                                             run(0, 0.7, 0.75)]})
    assert [r["seed"] for r in merged["runs"]] == [0, 1, 2]
    assert merged["runs"][0]["arco_dice"] == 0.75
    assert merged["summary"] == {"mean_supervised": 0.7, "mean_arco": 0.7833,
                                 "mean_gain": 0.0833, "min_gain": 0.05}
    with pytest.raises(SystemExit, match="tune_steps"):
        GATE.merge(str(path), {**head, "tune_steps": 450, "runs": []})
    assert GATE.artifact_name("striped") == "quality_gate_striped.json"


def test_the_script_refuses_another_out_before_any_seed(tmp_path,
                                                        monkeypatch):
    """An --out that holds another protocol's artifact stops the script
    before it trains a seed."""
    (tmp_path / "quality_gate.json").write_text(json.dumps(
        {"task": "shifted", "backend": "cuda", "runs": []}))

    def no_seed(*a, **k):
        raise AssertionError("a seed ran")
    monkeypatch.setattr(GATE, "run_seed", no_seed)
    with pytest.raises(SystemExit, match="use another --out"):
        GATE.main(["--device", "cpu", "--seeds", "0", "--out",
                   str(tmp_path)])


def test_the_script_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        GATE.main(["--seeds", "0", "--warm-steps", "1", "--tune-steps", "1"])


@pytest.mark.parametrize("script", ["torch_validate_semi_synthetic.py",
                                    "torch_validate_natural.py"])
def test_the_script_imports_nothing_of_jax(script):
    path = ROOT / "scripts" / script
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


# ---- the natural-image gate

def test_natural_fixture_is_byte_identical(tmp_path, monkeypatch):
    """Every JPEG (q95) and PNG and both split lists, seed 3."""
    monkeypatch.setattr(JAX_NATURAL, "MECHANISM", "striped")
    JAX_NATURAL.make_fixture(str(tmp_path / "jax"), 3)
    NATURAL.make_fixture(str(tmp_path / "port"), 3)
    files = sorted(str(p.relative_to(tmp_path / "jax"))
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 2 * (NATURAL.N_TRAIN + NATURAL.N_VAL) + 2
    assert files == sorted(str(p.relative_to(tmp_path / "port"))
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


def test_natural_argv_of_every_arm(monkeypatch):
    """The warmup, sup and arco arms' train_arco_natural argv and the two
    eval_natural argv, each script's run_arm with both CLIs stubbed."""
    import arco_tpu.cli.eval_natural as jax_eval
    import arco_tpu.cli.train_arco_natural as jax_train
    seen = {"jax": [], "port": []}
    result = {"miou": 0.5, "per_class_iou": [0.5] * 4}

    def train(key):
        def main(argv, wrap_step=None):     # the port's main takes a wrapper
            seen[key].append(("train", list(argv)))
            a = dict(zip(argv[::2], argv[1::2]))
            return os.path.join(a["--snapshot_dir"],
                                f"{a['--exp']}_{a['--label_num']}_labeled",
                                a["--model"])
        return main

    def evaluate(key):
        def main(argv):
            seen[key].append(("eval", list(argv)))
            print(json.dumps(result))
            return result
        return main

    monkeypatch.setattr(jax_train, "main", train("jax"))
    monkeypatch.setattr(jax_eval, "main", evaluate("jax"))
    monkeypatch.setattr(NATURAL.train_arco_natural, "main", train("port"))
    monkeypatch.setattr(NATURAL.eval_natural, "main", evaluate("port"))
    for run_arm, key in ((JAX_NATURAL.run_arm, "jax"),
                         (lambda *a, **k: NATURAL.run_arm(
                             *a, device="cpu", **k)[0], "port")):
        warm = run_arm("/r", "/s", "warm", 2)
        assert warm == "/s/gate/warm_s2_2_labeled/unet"
        for arm in ("sup", "arco"):
            assert run_arm("/r", "/s", arm, 2, warm_snapshot=warm) == result
    assert len(seen["port"]) == 5
    assert seen["port"] == seen["jax"]


def test_natural_seed_on_the_cpu(tmp_path):
    """One seed through the port's CLIs at 2 iterations an arm (the
    warmup too): finite losses, mIoUs in [0, 1], the JAX artifact's run
    keys and each arm's record."""
    run = NATURAL.run_seed(0, str(tmp_path), "cpu", iters=2, warm_iters=2,
                           extra=["--device", "cpu"])
    assert {"seed", "supervised_miou", "arco_miou", "gain", "sup_per_class",
            "arco_per_class"} <= set(run)
    assert all(0.0 <= run[k] <= 1.0 for k in ("supervised_miou",
                                              "arco_miou"))
    assert len(run["arco_per_class"]) == NATURAL.K_CLS
    assert abs(run["gain"] - (run["arco_miou"] - run["supervised_miou"])) \
        < 2e-4
    for arm in ("warmup", "supervised", "arco"):
        rec = run["timing"][arm]
        assert rec["iters"] == 2 and rec["nonfinite_losses"] == 0
        assert rec["ms_per_step"] > 0
        assert not any(rec["launches"].values())
    assert NATURAL.summarize([run])["min_gain"] == run["gain"]


def test_natural_script_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        NATURAL.main(["--seeds", "0", "--iters", "1", "--warm-iters", "1"])
