"""Pins of the port's method-quality gate artifacts.

``scripts/torch_validate_semi_synthetic.py`` trains the synthetic gates
through ``arco_torch`` on a CUDA GPU and writes
``docs/artifacts/quality_gate_torch/quality_gate.json`` (shifted),
``quality_gate_striped.json`` (striped) and
``quality_gate_noisy3d_confmask.json`` (noisy3d, the confmask arm gated);
``scripts/torch_validate_natural.py`` drives the port's natural CLIs and
writes ``quality_gate_natural.json`` (natural_striped). These tests hold
them to the JAX package's own gate: the thresholds are read from
``tests/test_quality_gate.py``'s ``FAMILIES`` (by path, never copied),
the protocol of each family (image or volume size, label budget,
unlabeled pool, warmup and tune steps or iterations, seeds; the 3D
family's volume, batch, noise and labeled volumes) must equal that of the
committed JAX artifact of the same name, and the runs must come from the
card: backend "cuda", bf16, the card's name and power limit as nvidia-smi
prints them, every loss finite, and each bf16 kernel route launched once a
step on the arms that compute the method's terms and never on the others.
A missing artifact fails.
"""

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ART_DIR = ROOT / "docs" / "artifacts" / "quality_gate_torch"
JAX_ART_DIR = ROOT / "docs" / "artifacts" / "quality_gate"
TASKS = ("shifted", "striped", "noisy3d_confmask", "natural_striped")
PROTOCOL_2D = ("hw", "n_labeled", "n_unlabeled", "warm_steps", "tune_steps")
PROTOCOL = {
    "shifted": PROTOCOL_2D,
    "striped": PROTOCOL_2D,
    "noisy3d_confmask": PROTOCOL_2D + ("vol", "batch", "noise_sigma",
                                       "labeled_volumes"),
    "natural_striped": ("hw", "n_train", "label_num", "iters", "warm_iters"),
}
# each family's run keys and its (supervised, ARCO) score keys
RUN_KEYS = {
    "shifted": {"seed", "warmup_dice", "supervised_dice",
                "supervised_buckets", "arco_dice", "arco_buckets", "gain"},
    "noisy3d_confmask": {"seed", "warmup_dice", "supervised_dice",
                         "ref_formula_arco_dice", "arco_dice", "gain"},
    "natural_striped": {"seed", "supervised_miou", "arco_miou", "gain",
                        "sup_per_class", "arco_per_class"},
}
RUN_KEYS["striped"] = RUN_KEYS["shifted"]
SCORES = {task: ("supervised_dice", "arco_dice") for task in TASKS}
SCORES["natural_striped"] = ("supervised_miou", "arco_miou")
BF16_ROUTES = ("infonce_fwd", "infonce_bwd", "pool_sims")


def _jax_gate():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_gate_thresholds", ROOT / "tests" / "test_quality_gate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FAMILIES = _jax_gate().FAMILIES


def _read(path):
    assert path.exists(), f"{path.relative_to(ROOT)} is missing"
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=TASKS)
def gate(request):
    task = request.param
    name = FAMILIES[task][0]
    return task, _read(ART_DIR / name), _read(JAX_ART_DIR / name)


def _arms(task, art):
    """{arm: (its steps, whether it computes the method's terms)}: the
    synthetic gates' supervised arms compute none; the natural gate's
    supervised arms zero the terms' weights (``SUP_OFF``) but compute
    them, as the JAX script's do."""
    if task == "natural_striped":
        return {"warmup": (art["warm_iters"], True),
                "supervised": (art["iters"], True),
                "arco": (art["iters"], True)}
    arms = {"warmup": (art["warm_steps"], False),
            "supervised": (art["tune_steps"], False),
            "arco": (art["tune_steps"], True)}
    if task == "noisy3d_confmask":
        arms["arco_confmask"] = (art["tune_steps"], True)
    return arms


def test_thresholds_are_the_jax_gates():
    assert FAMILIES["shifted"][1:] == (0.93, 0.03, 0.02)
    assert FAMILIES["striped"][1:] == (0.93, 0.10, 0.10)
    assert FAMILIES["noisy3d_confmask"][1:] == (0.93, 0.03, 0.02)
    assert FAMILIES["natural_striped"][1:] == (0.90, 0.05, 0.04)
    assert set(TASKS) == set(FAMILIES)


def test_artifact_matches_task(gate):
    task, art, jax_art = gate
    assert art["task"] == task
    assert len(art["runs"]) >= 2, "need >=2 seeds for a stable gate"
    for r in art["runs"]:
        assert RUN_KEYS[task] <= set(r)
        scores = [v for k, v in r.items()
                  if k.endswith(("_dice", "_miou"))]
        scores += [x for k in ("supervised_buckets", "arco_buckets",
                               "sup_per_class", "arco_per_class")
                   for x in r.get(k, ())]
        assert all(0.0 <= s <= 1.0 for s in scores)
    if task == "natural_striped":
        n_cls = len(jax_art["runs"][0]["arco_per_class"])
        assert all(len(r["sup_per_class"]) == len(r["arco_per_class"])
                   == n_cls for r in art["runs"])


def test_protocol_is_the_jax_artifacts(gate):
    task, art, jax_art = gate
    for key in PROTOCOL[task]:
        assert art[key] == jax_art[key], key
    assert sorted(r["seed"] for r in art["runs"]) == \
        sorted(r["seed"] for r in jax_art["runs"])


def test_runs_come_from_the_card(gate):
    task, art, _ = gate
    assert art["backend"] == "cuda"
    assert art["compute_dtype"] == "bfloat16"
    # nvidia-smi's "name, power.limit", e.g. "NVIDIA H100 80GB HBM3, 700.00 W"
    assert re.fullmatch(r"NVIDIA [^,]+, \d+(\.\d+)? W", art["device"]), \
        art["device"]
    count = "iters" if task == "natural_striped" else "steps"
    for r in art["runs"]:
        assert set(r["timing"]) == set(_arms(task, art))
        for arm, (n, method) in _arms(task, art).items():
            rec = r["timing"][arm]
            assert rec[count] == n
            assert rec["nonfinite_losses"] == 0, (task, r["seed"], arm)
            # the ARCO step runs each bf16 kernel once; a step that
            # computes none of the method's terms, none
            want = n if method else 0
            for route, launches in rec["launches"].items():
                assert launches == (want if route in BF16_ROUTES else 0), \
                    (task, r["seed"], arm, route)


def test_task_is_falsifiable(gate):
    """Supervised-only must land below the JAX gate's ceiling."""
    task, art, _ = gate
    ceiling = FAMILIES[task][1]
    assert art["summary"]["mean_supervised"] < ceiling


def test_arco_beats_supervised(gate):
    task, art, _ = gate
    _, _, min_mean, min_seed = FAMILIES[task]
    s = art["summary"]
    assert s["mean_gain"] >= min_mean, (
        f"[{task}] the port's ARCO gain {s['mean_gain']} < {min_mean}")
    assert s["min_gain"] >= min_seed, (
        f"[{task}] the port's worst-seed gain {s['min_gain']} < {min_seed}")


def test_gains_and_summary_consistent_with_runs(gate):
    task, art, _ = gate
    sup, arco = SCORES[task]
    runs = art["runs"]
    for r in runs:
        assert abs(r["gain"] - (r[arco] - r[sup])) < 2e-4
    mean = lambda xs: sum(xs) / len(xs)
    s = art["summary"]
    assert abs(s["mean_supervised"] - mean([r[sup] for r in runs])) < 1e-4
    assert abs(s["mean_arco"] - mean([r[arco] for r in runs])) < 1e-4
    assert abs(s["mean_gain"] - mean([r["gain"] for r in runs])) < 1e-4
    assert s["min_gain"] == min(r["gain"] for r in runs)
