"""The port's method-quality gate script against the JAX package's.

``scripts/torch_validate_semi_synthetic.py`` (the port's) is held against
``scripts/validate_semi_synthetic.py`` (JAX's, the oracle), both imported
by path:
- the data of both tasks bit for bit (``np.array_equal``, same dtype) at
  the JAX script's sizes, seeds 0 and 1;
- ``dice`` exactly, on seeded pairs and with a class absent;
- every arm's config, step count and seed field for field, the optimizer's
  settings, and the batch-index stream of ``run`` for 5 steps;
- ``evaluate`` at 32x32 from one set of U-Net weights carried from flax
  (``compat/from_flax.py``), both in f32 on the CPU: logits within atol
  1e-4, the same per-image Dice and the same mean;
- one ``run_seed`` of each task on the CPU at 32x32 (2 warm and 2 tune
  steps, small banks and pool): the artifact keys, every Dice in [0, 1];
- the script imports neither JAX nor the JAX package (``ast``).
"""

import ast
import dataclasses
import importlib.util
import inspect
import json
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


@pytest.mark.parametrize("task", ["shifted", "striped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_make_data_is_bit_identical(task, seed):
    want = JAX_GATE.make_data(task, seed)
    got = GATE.make_data(task, seed)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_constants_match():
    for name in ("HW", "B", "K", "N_LABELED", "N_UNLABELED", "N_VAL",
                 "N_WARM", "N_TUNE", "GAIN_LO", "GAIN_HI", "OFF_MAX"):
        assert getattr(GATE, name) == getattr(JAX_GATE, name), name


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


def _arm_calls(monkeypatch):
    """Each script's run_seed over every arm, with ``run`` recording (tag,
    config, steps, seed) and the data and evaluation stubbed."""
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
    JAX_GATE.run_seed("shifted", 7, jnp.float32, arms=ALL_ARMS, n_tune=11,
                      n_warm=5)
    GATE.run_seed("shifted", 7, "cpu", arms=ALL_ARMS, n_tune=11, n_warm=5)
    return calls


def test_configs_steps_and_seeds_match(monkeypatch):
    """Warmup, both arms and the five triage arms: the same ArcoConfig on
    every field (the two dataclasses have the same fields), the same step
    count and seed, in the same order."""
    jax_fields = {f.name for f in dataclasses.fields(JaxArcoConfig)}
    assert {f.name for f in dataclasses.fields(ArcoConfig)} == jax_fields
    calls = _arm_calls(monkeypatch)
    assert len(calls["port"]) == len(calls["jax"]) == 8
    for (tag_p, cfg_p, steps_p, seed_p), (tag_j, cfg_j, steps_j, seed_j) in \
            zip(calls["port"], calls["jax"]):
        assert tag_p == tag_j
        assert cfg_p == cfg_j, tag_p
        assert (steps_p, seed_p) == (steps_j, seed_j), tag_p
    assert [c[2:] for c in calls["port"][:3]] == [(5, 7), (11, 8), (11, 8)]


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


def test_batch_index_stream_matches(monkeypatch):
    """The first 5 batches of ``run``: images that carry their own index,
    through each script's real loop with the model and step stubbed."""
    n_l, n_u, steps, seed = 2, 128, 5, 3
    img_l = np.arange(n_l, dtype=np.float32).reshape(n_l, 1, 1, 1)
    img_u = np.arange(n_u, dtype=np.float32).reshape(n_u, 1, 1, 1)
    lab_l = np.zeros((n_l, 1, 1), np.int32)
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
    data = tuple(torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2)) if x.ndim == 4 else x)
        for x in (img_l, lab_l, img_u))
    GATE.run(None, "t", steps, data, torch.device("cpu"), seed=seed, hw=1)

    assert len(seen["jax"]) == steps
    assert seen["port"] == seen["jax"]
    index = GATE.batch_indices(seed, n_l, n_u)
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


def test_the_script_imports_nothing_of_jax():
    path = ROOT / "scripts" / "torch_validate_semi_synthetic.py"
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
