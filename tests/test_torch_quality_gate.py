"""Pins of the port's method-quality gate artifacts.

``scripts/torch_validate_semi_synthetic.py`` trains the 2D gate through
``arco_torch`` on a CUDA GPU and writes
``docs/artifacts/quality_gate_torch/quality_gate.json`` (shifted) and
``quality_gate_striped.json`` (striped). These tests hold them to the JAX
package's own gate: the thresholds are read from
``tests/test_quality_gate.py``'s ``FAMILIES`` (by path, never copied), the
protocol (image size, label budget, unlabeled pool, warmup and tune
steps, seeds) must equal that of the committed JAX artifact of the same
task, and the runs must come from the card: backend "cuda", bf16, the
card's name and power limit as nvidia-smi prints them, every loss finite,
and each bf16 kernel route launched once an ARCO step and never on a
supervised one. A missing artifact fails.
"""

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ART_DIR = ROOT / "docs" / "artifacts" / "quality_gate_torch"
JAX_ART_DIR = ROOT / "docs" / "artifacts" / "quality_gate"
TASKS = ("shifted", "striped")
PROTOCOL = ("hw", "n_labeled", "n_unlabeled", "warm_steps", "tune_steps")
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


def test_thresholds_are_the_jax_gates():
    assert FAMILIES["shifted"][1:] == (0.93, 0.03, 0.02)
    assert FAMILIES["striped"][1:] == (0.93, 0.10, 0.10)


def test_artifact_matches_task(gate):
    task, art, _ = gate
    assert art["task"] == task
    assert len(art["runs"]) >= 2, "need >=2 seeds for a stable gate"
    for r in art["runs"]:
        assert {"seed", "warmup_dice", "supervised_dice",
                "supervised_buckets", "arco_dice", "arco_buckets",
                "gain"} <= set(r)
        dices = [r["warmup_dice"], r["supervised_dice"], r["arco_dice"],
                 *r["supervised_buckets"], *r["arco_buckets"]]
        assert all(0.0 <= d <= 1.0 for d in dices)


def test_protocol_is_the_jax_artifacts(gate):
    _, art, jax_art = gate
    for key in PROTOCOL:
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
    steps = {"warmup": art["warm_steps"], "supervised": art["tune_steps"],
             "arco": art["tune_steps"]}
    for r in art["runs"]:
        for arm, n in steps.items():
            rec = r["timing"][arm]
            assert rec["steps"] == n
            assert rec["nonfinite_losses"] == 0, (task, r["seed"], arm)
            # the ARCO step runs each bf16 kernel once; the supervised one
            # none
            want = n if arm == "arco" else 0
            for route, count in rec["launches"].items():
                assert count == (want if route in BF16_ROUTES else 0), \
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
    _, art, _ = gate
    runs = art["runs"]
    for r in runs:
        assert abs(r["gain"] - (r["arco_dice"] - r["supervised_dice"])) \
            < 2e-4
    mean = lambda xs: sum(xs) / len(xs)
    s = art["summary"]
    assert abs(s["mean_supervised"]
               - mean([r["supervised_dice"] for r in runs])) < 1e-4
    assert abs(s["mean_arco"] - mean([r["arco_dice"] for r in runs])) < 1e-4
    assert abs(s["mean_gain"] - mean([r["gain"] for r in runs])) < 1e-4
    assert s["min_gain"] == min(r["gain"] for r in runs)
