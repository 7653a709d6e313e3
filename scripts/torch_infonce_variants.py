#!/usr/bin/env python3
"""Time variants of this tree's InfoNCE kernel pair on one CUDA GPU, to
find what its time goes to: each variant is a copy of ``arco_torch/`` whose
``kernels/csrc/infonce.cu`` has one edit (below), built under
``build/infonce_variants/<name>``, and timed by
``scripts/torch_infonce_ab.py`` at its four shapes, 'smc' draws, device ms,
without the results' check (some variants compute wrong results on
purpose).

    python3 scripts/torch_infonce_variants.py [NAME ...]

With no names it runs every variant, the tree itself first and last. An
edit that no longer matches the source stops the script.
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

# name -> (what it tests, [(text, replacement)])
VARIANTS = {
    "tree": ("this tree", []),
    "copies_only": (
        "each stage's compute taken out of both kernels: the plan, the "
        "staged copies, the barriers and the outputs alone",
        [(FWD_STAGE, SKIP + FWD_STAGE[FWD_STAGE.index("    const"):]),
         (BWD_STAGE, SKIP + BWD_STAGE[BWD_STAGE.index("    const"):])]),
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
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"infonce.cu once")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def main(argv):
    if argv[:1] == ["--one"]:
        spec = importlib.util.spec_from_file_location(
            "torch_infonce_ab", REPO / "scripts" / "torch_infonce_ab.py")
        ab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ab)
        ab.grid_ms = lambda fn, reps=20: None
        ab.host_ms = lambda fn, reps=100: float("nan")
        ab.run_one(Path(argv[1]), check=False, only_main_draw=True)
        return 0
    names = argv or [*VARIANTS, "tree"]
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
        out = subprocess.run([sys.executable, __file__, "--one",
                              str(OUT / name)], stdout=subprocess.PIPE,
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
