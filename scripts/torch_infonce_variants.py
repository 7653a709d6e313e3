#!/usr/bin/env python3
"""Time variants of this tree's InfoNCE kernel pair on one CUDA GPU, to
find what its time goes to: each variant is a copy of ``arco_torch/`` whose
``kernels/csrc/infonce.cu`` has one edit (below), built under
``build/infonce_variants/<name>``, and timed by
``scripts/torch_infonce_ab.py`` at its four shapes, 'smc' draws, device ms,
without the results' check (some variants compute wrong results on
purpose).

    python3 scripts/torch_infonce_variants.py [--f32] [NAME ...]

With no names it runs every variant of the route, the tree itself first
and last. An
edit that no longer matches the source stops the script. With ``--f32``
the variants are timed on the f32 route, at its 2D and 3D shapes
('smc'): ``copies_only_f32`` is the one variant made for that route.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "infonce_variants"
FWD_STAGE = ("  walk(kb, L, t, sm, [&](int st, const uint4* slot) {\n"
             "    const int h0 = st * L.rows;\n    const int mtiles")
BWD_STAGE = ("  walk(kb, L, t, sm, [&](int st, const uint4* slot) {\n"
             "    const int h0 = st * L.rows;\n    const int nr")
SKIP = "  walk(kb, L, t, sm, [&](int st, const uint4* slot) {\n    return;\n"
# the first line of each f32 kernel's stage work
F32_STAGE = ("[&](int st, const uint4* slot) {\n"
             "    const int oa = sm.ostart[st], ob = sm.ostart[st + 1];\n")

COPIES_ONLY_F32 = (F32_STAGE, F32_STAGE.replace("{\n", "{\n    return;\n", 1),
                   2)
SLOTS_4 = [("kMaxSlotsF32 = 8;", "kMaxSlotsF32 = 4;"),
           ("kMinStageF32 = 16;", "kMinStageF32 = 11;")]

# name -> (what it tests, [(text, replacement[, times it occurs])])
VARIANTS = {
    "tree": ("this tree", []),
    "copies_only": (
        "each stage's compute taken out of both kernels: the plan, the "
        "staged copies, the barriers and the outputs alone",
        [(FWD_STAGE, SKIP + FWD_STAGE[FWD_STAGE.index("    const"):]),
         (BWD_STAGE, SKIP + BWD_STAGE[BWD_STAGE.index("    const"):])]),
    "copies_only_f32": (
        "each stage's compute taken out of both f32 kernels: the plan, the "
        "staged copies, the ring's waits and the outputs alone",
        [COPIES_ONLY_F32]),
    "copies_only_slots_4_f32": ("copies_only_f32 with slots_4_f32's ring",
                                [COPIES_ONLY_F32, *SLOTS_4]),
    "no_walk_f32": (
        "the f32 kernels without their walk: the launch, the plan, the "
        "outputs and the folded split sum alone",
        [("  for (int st = warp; st < imin(D, t.stages); st += kWarps)\n",
          "  if (D > 0) return;\n"
          "  for (int st = warp; st < imin(D, t.stages); st += kWarps)\n")]),
    "no_fold_f32": (
        "the f32 kernels without their folded split sum (each block "
        "writes its partial only)",
        [("  const int S = gridDim.y;\n  // the barrier orders",
          "  const int S = gridDim.y;\n  if (S > 0) return;\n"
          "  // the barrier orders")]),
    "compute_1pass_f32": (
        "the f32 kernels' stage work cut to its first pass of samples",
        [("for (int nl = na + 2 * slice; nl <= nb; nl += 2 * nsl)",
          "for (int nl = na + 2 * slice; nl <= na; nl += 2 * nsl)"),
         ("for (int nl = na + slice; nl <= nb; nl += nsl)",
          "for (int nl = na + slice; nl <= na; nl += nsl)")]),
    "slots_3_f32": ("the f32 ring with 3 slots at C 496 (15 rows a stage)",
                    [("kMaxSlotsF32 = 8;", "kMaxSlotsF32 = 3;"),
                     ("kMinStageF32 = 16;", "kMinStageF32 = 15;")]),
    "slots_4_f32": ("the f32 ring with 4 slots (11 rows a stage at C 496)",
                    SLOTS_4),
    "slots_8_f32": ("the f32 ring with 8 slots (5 rows a stage at C 496)",
                    [("kMinStageF32 = 16;", "kMinStageF32 = 1;")]),
    "tma_all_f32": ("the f32 route copies every row with TMA (C = 16 too)",
                    [("kTmaRowF32 = 1024;", "kTmaRowF32 = 16;")]),
    "tma_none_f32": ("the f32 route copies every row with cp.async",
                     [("kTmaRowF32 = 1024;", "kTmaRowF32 = 1 << 30;")]),
    "lanes_16_f32": (
        "the f32 forward with as many lanes a pair as chunks, up to 16 (4 "
        "at C 16)",
        [("while (lanes < imin(cr / 2, kLanesF32)) lanes *= 2;",
          "while (lanes < imin(cr, kLanesF32)) lanes *= 2;")]),
    "splits_4": (
        "always 4 chunks of the samples (no more blocks at small K * Q)",
        [("kMinSplits = 4, kMaxSplits = 16;",
          "kMinSplits = 4, kMaxSplits = 4;")]),
    "rows_32": ("at most 32 rows a stage",
                [("kMaxRows = 512;", "kMaxRows = 32;")]),
    "blocks_2": ("layouts sized for 2 blocks an SM",
                 [("constexpr int kMaxBlocks = 3;",
                   "constexpr int kMaxBlocks = 2;")]),
    "fwd_bound_3": ("the forward's launch bounds at 3 blocks an SM",
                    [("__launch_bounds__(kThreads, 2)\ninfonce_fwd_kernel",
                      "__launch_bounds__(kThreads, 3)\ninfonce_fwd_kernel")]),
}


def make(name: str) -> Path:
    root = OUT / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(REPO / "arco_torch", root / "arco_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / "arco_torch" / "kernels" / "csrc" / "infonce.cu"
    text = src.read_text()
    for old, new, *times in VARIANTS[name][1]:
        times = times[0] if times else 1
        if text.count(old) != times:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"infonce.cu {times} times")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def main(argv):
    f32 = argv[:1] == ["--f32"]
    argv = argv[f32:]
    if argv[:1] == ["--one"]:
        spec = importlib.util.spec_from_file_location(
            "torch_infonce_ab", REPO / "scripts" / "torch_infonce_ab.py")
        ab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ab)
        ab.host_ms = lambda fn, reps=100: float("nan")
        ab.run_one(Path(argv[1]), check=False, only_main_draw=True, f32=f32,
                   grids=False)
        return 0
    names = argv or [*(v for v in VARIANTS if v.endswith("_f32") == f32),
                     "tree"]
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name}; known: "
                             f"{', '.join(VARIANTS)}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    for name in dict.fromkeys(names):
        print(f"{name}: {VARIANTS[name][0]}", flush=True)
        make(name)
    for name in names:
        out = subprocess.run([sys.executable, __file__, *["--f32"] * f32,
                              "--one", str(OUT / name)],
                             stdout=subprocess.PIPE,
                             text=True, check=True, timeout=900).stdout
        for line in out.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                print(f"{name:12s} {r['shape']:13s} {r['kernel']} "
                      f"{r['device_ms']:.4f} (bound {r['bound_ms']:.4f})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
