"""Paper-reproduction kit: every published ARCO configuration as an exact
arco_torch CLI invocation (counterpart of arco_tpu/repro.py).

The paper (arXiv:2302.01735, NeurIPS 2023) evaluates eight benchmarks —
ACDC / MMWHS / Synapse / LiTS (2D slices), LA (3D volumes), and
Cityscapes / Pascal VOC (natural images) — at 1/5/10 %-style label budgets.
The repository pins the protocols, budgets and split lists but not the
numbers (BASELINE.md §1-2); this module pins the *commands*, so the day the
datasets are present the whole quality gate is:

    python -m arco_torch.repro acdc_5 --root /data/ACDC --run

Every recipe follows the reference two-stage protocol: stage-1 ISD pretrain
(pretrain_2D.py / pretrain_3D.py, 6000 iterations, pretrain_2D.py:39-40),
stage-2 ARCO initialised from it via --resume (train_arco_2d.py:223-226),
then the checkpoint-sweep evaluation (test_2D.py:140-157 / test_3D.py:39-41).
Label budgets come from patients_to_slices (train_arco_2d.py:91-106) keyed
by the exp name; the canonical splits ship in dataset_split/ (README.txt).

Stage argvs are validated (tests/test_torch_port_repro.py) by dry-run
parsing through each port CLI's own parser and checking the split lists
exist; no real data needed. The stages run on the card (every port CLI's
default device).

Placeholders substituted by build_commands():
    {root}  dataset root (--root <path>)
    {snap}  snapshot dir (--snapshot_dir, default ../model)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str           # pretrain | train | eval
    module: str         # arco_torch.cli.<entry>
    argv: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Recipe:
    description: str
    splits_dir: str                  # dataset_split/<dir> with the lists
    lists: Tuple[str, ...]           # required split-list files
    stages: Tuple[Stage, ...]
    notes: str = ""


def _two_stage_2d(exp: str, labeled_num: int, num_classes: int,
                  pre_exp: str) -> Tuple[Stage, ...]:
    """Reference 2D protocol: 6k ISD pretrain -> 30k ARCO -> sweep.

    Budgets: pretrain_2D.py:39-40 (6000), train_arco_2d.py:33-39 (30000,
    batch 4 = 2 labeled + 2 unlabeled, SGD lr 0.01 poly^0.9), eval sweep
    test_2D.py:140-157 (every 1000 iterations).
    """
    common = ["--root_path", "{root}", "--snapshot_dir", "{snap}",
              "--labeled_num", str(labeled_num),
              "--num_classes", str(num_classes)]
    return (
        Stage("pretrain", "arco_torch.cli.pretrain_2d", tuple(
            common + ["--exp", pre_exp, "--max_iterations", "6000",
                      "--batch_size", "4", "--labeled_bs", "2",
                      "--base_lr", "0.01"])),
        Stage("train", "arco_torch.cli.train_arco_2d", tuple(
            common + ["--exp", exp, "--resume", pre_exp,
                      "--max_iterations", "30000",
                      "--batch_size", "4", "--labeled_bs", "2",
                      "--base_lr", "0.01", "--patch_size", "256", "256"])),
        Stage("eval", "arco_torch.cli.test_2d", tuple(
            common + ["--exp", exp, "--startEpoch", "1000",
                      "--endEpoch", "30000", "--stepEpoch", "1000"])),
    )


def _two_stage_3d(exp: str, labeled_num: int, pre_exp: str) -> Tuple[Stage, ...]:
    """Reference 3D protocol: ISD_3d pretrain -> 6k ARCO -> sliding-window
    sweep (train_arco_3d.py:33-39, test_3D.py:31-41: patch [112,112,80],
    strides 18/4)."""
    common = ["--root_path", "{root}", "--snapshot_dir", "{snap}",
              "--labeled_num", str(labeled_num), "--num_classes", "2"]
    return (
        Stage("pretrain", "arco_torch.cli.pretrain_3d", tuple(
            common + ["--exp", pre_exp, "--max_iterations", "6000",
                      "--batch_size", "4", "--labeled_bs", "2",
                      "--patch_size", "112", "112", "80"])),
        Stage("train", "arco_torch.cli.train_arco_3d", tuple(
            common + ["--exp", exp, "--resume", pre_exp,
                      "--max_iterations", "6000", "--batch_size", "4",
                      "--labeled_bs", "2", "--base_lr", "0.01",
                      "--patch_size", "112", "112", "80"])),
        Stage("eval", "arco_torch.cli.test_3d", tuple(
            common + ["--exp", exp, "--startEpoch", "1000",
                      "--endEpoch", "6000", "--stepEpoch", "1000",
                      "--patch_size", "112", "112", "80",
                      "--stride_xy", "18", "--stride_z", "4"])),
    )


def _natural(dataset: str, label_num: int, iters: int) -> Tuple[Stage, ...]:
    exp = f"natural/{dataset}_{label_num}"
    return (
        Stage("train", "arco_torch.cli.train_arco_natural", (
            "--root_path", "{root}", "--snapshot_dir", "{snap}",
            "--dataset", dataset, "--label_num", str(label_num),
            "--max_iterations", str(iters), "--exp", exp)),
        Stage("eval", "arco_torch.cli.eval_natural", (
            "--root_path", "{root}", "--snapshot_dir", "{snap}",
            "--dataset", dataset, "--label_num", str(label_num),
            "--exp", exp)),
    )


_MED_LISTS = ("train_all.list", "train_1_.list", "train_5_.list",
              "train_10_.list", "test.list")

RECIPES: Dict[str, Recipe] = {
    # ---- ACDC (4 classes: bg/RV/Myo/LV), budgets 1/3/7 patients =
    # 1%/5%/10% -> 23/68/136 labeled slices (train_arco_2d.py:93-99) ----
    "acdc_1": Recipe(
        "ACDC 1% labels (1 patient, 23 slices)", "ACDC_lists",
        _MED_LISTS + ("val.list",),
        _two_stage_2d("ACDC/arco", 1, 4, "ACDC/pretrain")),
    "acdc_5": Recipe(
        "ACDC 5% labels (3 patients, 68 slices)", "ACDC_lists",
        _MED_LISTS + ("val.list",),
        _two_stage_2d("ACDC/arco", 3, 4, "ACDC/pretrain")),
    "acdc_10": Recipe(
        "ACDC 10% labels (7 patients, 136 slices)", "ACDC_lists",
        _MED_LISTS + ("val.list",),
        _two_stage_2d("ACDC/arco", 7, 4, "ACDC/pretrain")),
    # ---- MMWHS (8 classes: bg + 7 heart substructures), budgets keyed by
    # the MM map (train_arco_2d.py:95: 1->38, 2->76, 5->191, 10->382) ----
    "mmwhs_1": Recipe(
        "MMWHS 1% labels (1 case, 38 slices)", "MMHWS_lists", _MED_LISTS,
        _two_stage_2d("MM/arco", 1, 8, "MM/pretrain")),
    "mmwhs_10": Recipe(
        "MMWHS 10% labels (10 cases, 382 slices)", "MMHWS_lists", _MED_LISTS,
        _two_stage_2d("MM/arco", 10, 8, "MM/pretrain")),
    # ---- Synapse multi-organ (9 classes, TransUNet protocol); Syn map
    # (train_arco_2d.py:97: 1->44, 3->66, 5->111, 10->221) ----
    "synapse_5": Recipe(
        "Synapse 5% labels (111 slices)", "Lits_lists", ("test.list",),
        _two_stage_2d("Synapse/arco", 5, 9, "Synapse/pretrain"),
        notes="Synapse reads npz slices under {root}/data/Synapse/train_npz "
              "(train_arco_2d.py:162-169); the reference ships no separate "
              "Synapse split dir — lists ride inside the npz tree."),
    # ---- LiTS (3 classes: bg/liver/tumor; '_40' list suffix,
    # build_dataset.py:131-134), Lits map 1->167, 5->835, 10->1668 ----
    "lits_5": Recipe(
        "LiTS 5% labels (835 slices)", "Lits_lists", _MED_LISTS,
        _two_stage_2d("Lits/arco", 5, 3, "Lits/pretrain")),
    "lits_10": Recipe(
        "LiTS 10% labels (1668 slices)", "Lits_lists", _MED_LISTS,
        _two_stage_2d("Lits/arco", 10, 3, "Lits/pretrain")),
    # ---- LA heart 3D (binary), labeled cases of 80 total:
    # 10% = 8 cases (LAHeartWithIndex index semantics, la_heart.py:46) ----
    "la_10": Recipe(
        "LA 10% labels (8 of 80 volumes), V-Net 112x112x80", "LA_lists",
        _MED_LISTS, _two_stage_3d("LA/arco", 8, "LA/pretrain")),
    # ---- natural images (no trainer in the reference snapshot; budgets
    # follow dataset_split/{Pascal,Cityscapes}_lists and the U2PL-style
    # BuildDataLoader defaults, dataset/build_dataset.py:262-280) ----
    "pascal_60": Recipe(
        "Pascal VOC, 60 labeled images", "Pascal_lists",
        ("train_all.list", "train_60.list", "test.list"),
        _natural("pascal", 60, 40000)),
    "pascal_600": Recipe(
        "Pascal VOC, 600 labeled images", "Pascal_lists",
        ("train_all.list", "train_600.list", "test.list"),
        _natural("pascal", 600, 40000)),
    "cityscapes_20": Recipe(
        "Cityscapes, 20 labeled images", "Cityscapes_lists",
        ("train_all.list", "train_20.list", "test.list"),
        _natural("cityscapes", 20, 40000)),
    "cityscapes_150": Recipe(
        "Cityscapes, 150 labeled images", "Cityscapes_lists",
        ("train_all.list", "train_150.list", "test.list"),
        _natural("cityscapes", 150, 40000)),
}


def build_commands(name: str, root: str = "{root}",
                   snap: str = "../model") -> List[Tuple[str, List[str]]]:
    """Resolve a recipe into [(module, argv), ...] with paths substituted."""
    rec = RECIPES[name]
    out = []
    for st in rec.stages:
        argv = [a.replace("{root}", root).replace("{snap}", snap)
                for a in st.argv]
        out.append((st.module, argv))
    return out


def validate_stage(module: str, argv: Sequence[str]) -> None:
    """Dry-run parse a stage argv through the CLI's own parser. Raises on
    any flag the target entry point would reject."""
    import importlib
    argv = list(argv)
    if module in ("arco_torch.cli.train_arco_2d",
                  "arco_torch.cli.pretrain_2d"):
        from arco_torch.config import parse_args
        parse_args(argv)
    elif module in ("arco_torch.cli.train_arco_3d",
                    "arco_torch.cli.pretrain_3d"):
        from arco_torch.config import parse_args
        mod = importlib.import_module(module)
        parse_args(argv, base=mod.default_3d_config())
    else:
        mod = importlib.import_module(module)
        mod.build_parser().parse_args(argv)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Paper-reproduction kit: print or run the exact CLI "
                    "commands for a published ARCO configuration.")
    p.add_argument("recipe", nargs="?", help="recipe name (see --list)")
    p.add_argument("--list", action="store_true", dest="list_recipes")
    p.add_argument("--root", default="{root}", help="dataset root path")
    p.add_argument("--snapshot_dir", default="../model")
    p.add_argument("--run", action="store_true",
                   help="execute the stages in order (default: print only)")
    p.add_argument("--validate", action="store_true",
                   help="dry-run parse every recipe's argv (CI gate)")
    args = p.parse_args(argv)

    if args.list_recipes:
        for k, r in RECIPES.items():
            print(f"{k:16s} {r.description}")
        return
    if args.validate:
        for k, r in RECIPES.items():
            for mod, stage_argv in build_commands(k, "/tmp/x", "/tmp/m"):
                validate_stage(mod, stage_argv)
            print(f"{k}: ok ({len(r.stages)} stages)")
        return
    if not args.recipe:
        p.error("recipe name required (or --list / --validate)")
    rec = RECIPES[args.recipe]
    print(f"# {rec.description}")
    if rec.notes:
        print(f"# NOTE: {rec.notes}")
    print(f"# splits: dataset_split/{rec.splits_dir}/ "
          f"({', '.join(rec.lists)})")
    cmds = build_commands(args.recipe, args.root, args.snapshot_dir)
    for mod, stage_argv in cmds:
        print("python -m", mod, " ".join(stage_argv))
    if args.run:
        if args.root == "{root}":
            p.error("--run requires --root")
        import importlib
        for mod, stage_argv in cmds:
            print(f"== running {mod} ==", flush=True)
            importlib.import_module(mod).main(stage_argv)


if __name__ == "__main__":
    main()
