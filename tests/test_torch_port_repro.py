"""The port's paper-reproduction kit (arco_torch/repro.py), case for case
as tests/test_repro_kit.py holds arco_tpu.repro: every recipe's argv
parses through the port CLI's own parser, every split list ships, the
stages hand off, the label budgets resolve, and the CLI lists, prints
and validates. Beyond that: the port's recipes are JAX's, stage for
stage, with only the module package changed, and each stage also parses
through the ``parse`` that the port CLI's ``main`` runs."""

import os

import pytest

from arco_tpu import repro as jax_repro

from arco_torch import repro

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(repro.RECIPES))
def test_recipe_parses(name):
    for mod, argv in repro.build_commands(name, "/tmp/data", "/tmp/model"):
        repro.validate_stage(mod, argv)


@pytest.mark.parametrize("name", sorted(repro.RECIPES))
def test_recipe_split_lists_exist(name):
    rec = repro.RECIPES[name]
    split_dir = os.path.join(REPO, "dataset_split", rec.splits_dir)
    assert os.path.isdir(split_dir), split_dir
    for lst in rec.lists:
        assert os.path.isfile(os.path.join(split_dir, lst)), (name, lst)


@pytest.mark.parametrize("name", sorted(repro.RECIPES))
def test_recipe_equals_jax(name):
    want = jax_repro.build_commands(name, "/d", "/m")
    got = repro.build_commands(name, "/d", "/m")
    assert [(m.replace("arco_tpu.", "arco_torch."), a) for m, a in want] \
        == got
    rec, jrec = repro.RECIPES[name], jax_repro.RECIPES[name]
    assert (rec.description, rec.splits_dir, rec.lists, rec.notes) == \
        (jrec.description, jrec.splits_dir, jrec.lists, jrec.notes)


@pytest.mark.parametrize("name", sorted(repro.RECIPES))
def test_recipe_parses_through_cli_parse(name):
    """The training stages' own ``parse`` (what ``main`` runs: the pretrain
    CLIs' snapshot suffix and optimizer defaults on top of
    ``config.parse_args``) accepts the argv too."""
    import importlib
    for mod, argv in repro.build_commands(name, "/tmp/data", "/tmp/model"):
        cli = importlib.import_module(mod)
        if hasattr(cli, "parse"):
            cli.parse(argv)


def test_recipe_stage_order():
    """Two-stage recipes must hand off: the ARCO stage resumes the pretrain
    exp, and eval targets the ARCO exp at the trained budget."""
    for name, rec in repro.RECIPES.items():
        stages = {s.name: list(s.argv) for s in rec.stages}
        if "pretrain" not in stages:
            continue
        pre_exp = stages["pretrain"][stages["pretrain"].index("--exp") + 1]
        tr = stages["train"]
        assert tr[tr.index("--resume") + 1] == pre_exp, name
        ev = stages["eval"]
        train_exp = tr[tr.index("--exp") + 1]
        assert ev[ev.index("--exp") + 1] == train_exp, name
        end = int(ev[ev.index("--endEpoch") + 1])
        budget = int(tr[tr.index("--max_iterations") + 1])
        assert end == budget, name


def test_label_budget_consistency():
    """Recipe labeled_num values must resolve through the port's
    patients_to_slices for the 2D medical exps (train_arco_2d.py:91-106)."""
    from arco_torch.config import patients_to_slices
    expected = {"acdc_1": 23, "acdc_5": 68, "acdc_10": 136,
                "mmwhs_1": 38, "mmwhs_10": 382,
                "synapse_5": 111, "lits_5": 835, "lits_10": 1668}
    for name, slices in expected.items():
        rec = repro.RECIPES[name]
        tr = list(rec.stages[1].argv)
        exp = tr[tr.index("--exp") + 1]
        ln = int(tr[tr.index("--labeled_num") + 1])
        assert patients_to_slices(exp, ln) == slices, name


def test_cli_lists_and_validate(capsys):
    repro.main(["--list"])
    out = capsys.readouterr().out
    for name in repro.RECIPES:
        assert name in out
    repro.main(["acdc_5", "--root", "/data/ACDC"])
    out = capsys.readouterr().out
    assert "python -m arco_torch.cli.train_arco_2d" in out
    assert "--resume ACDC/pretrain" in out
    repro.main(["--validate"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(repro.RECIPES)
    assert all(": ok (" in line for line in lines)


def test_run_needs_a_root():
    with pytest.raises(SystemExit):
        repro.main(["acdc_5", "--run"])
